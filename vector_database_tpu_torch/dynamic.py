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

Besides the host tombstone mask ``_main_alive`` (by input row), the
state is ``_Main`` (a compaction epoch), ``_Removal`` (a removal epoch)
and ``_Delta`` (the delta's rows in one device buffer); an add touches
only the delta. Unlike the JAX class, ``compact`` gathers the live main
rows on the device, and the delta merge runs there (``ops/delta_knn.py``)
and keeps the earlier add on equal distances, where the JAX class's host
partial sort keeps arbitrary rows on a tie at the k-th distance.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vector_database_tpu_torch.builder import build_index_fused
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.delta_knn import delta_knn
from vector_database_tpu_torch.ops.exact import (
    as_f32,
    atleast_2d,
    exact_d2_blocked,
    to_numpy,
)
from vector_database_tpu_torch.ops.packed_knn import (
    PackedDB,
    pack_database,
    pallas_scan_knn_packed,
)
from vector_database_tpu_torch.ops.scan_knn import scan_knn
from vector_database_tpu_torch.search import search as bsp_search
from vector_database_tpu_torch.utils.device import resolve_device
from vector_database_tpu_torch.utils.profiling import COUNTERS, span, spanned


@dataclass
class _Main:
    """A compaction epoch: the tree (None while empty), the external id
    of each input row and of each leaf-major row, the input row of each
    id (-1 if none), and the unmasked pack, built at the first packed
    request."""

    index: Optional[BSPIndex]
    ids: np.ndarray
    leaf_ids: np.ndarray
    row_of: np.ndarray
    pack: Optional[PackedDB] = None


@dataclass
class _Removal:
    """A removal epoch: the main matrix (``index.vectors`` itself; None
    while no main row is alive), its leaf-major alive mask on the device
    (None while nothing is removed), and the base pack with that mask in
    its norm row, built at the first packed request."""

    rows: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    pack: Optional[PackedDB] = None


class _Delta:
    """The delta: its rows in add order in ``rows[:size]``, one float32
    device buffer of the smallest power of two >= max(64, size) rows, and
    their ids (host). ``view``, built at the first merge after a change:
    the ids on the device, a slot each (-1 past ``size``), and the live
    slots as ``delta_knn`` takes them."""

    def __init__(self):
        self.rows: Optional[torch.Tensor] = None
        self.ids = np.zeros((0,), np.int64)
        self.view = None

    @property
    def size(self) -> int:
        return self.ids.size

    @property
    def live(self) -> torch.Tensor:
        return self.rows[:self.size]

    def _fit(self, n: int, like: torch.Tensor) -> None:
        """Reallocate where ``n`` rows change the capacity; keep ``live``."""
        cap = max(64, 1 << (n - 1).bit_length())
        if self.rows is None or self.rows.shape[0] != cap:
            old, self.rows = self.rows, like.new_zeros((cap, like.shape[1]))
            if old is not None:
                self.rows[:self.size] = old[:self.size]
        self.view = None

    def append(self, rows: torch.Tensor, ids: np.ndarray) -> None:
        self._fit(self.size + ids.size, rows)
        self.rows[self.size:self.size + ids.size] = rows
        self.ids = np.concatenate([self.ids, ids])

    def keep(self, keep: np.ndarray) -> None:
        """Keep the rows where ``keep`` is True, in order, in place."""
        kept = int(keep.sum())
        self.rows[:kept] = self.live[torch.from_numpy(keep).to(
            self.rows.device)]
        self.ids = self.ids[keep]
        self._fit(kept, self.rows)

    def merge_view(self):
        """``(ids [capacity] on the device, live slots [size] int32)``."""
        if self.view is None:
            with span("vdb_torch.dynamic.delta_view"):
                dev, pad = self.rows.device, self.rows.shape[0] - self.size
                self.view = (torch.from_numpy(np.pad(
                    self.ids, (0, pad), constant_values=-1)).to(dev),
                    torch.arange(self.size, dtype=torch.int32, device=dev))
        return self.view


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
        self._dims: Optional[int] = None
        self._delta = _Delta()
        self._set_main(None, np.zeros((0,), np.int64))
        if vectors is not None:
            self.add(vectors)
            if self._delta.size:  # add's threshold may have compacted
                self.compact()

    def _set_main(self, index: Optional[BSPIndex], ids: np.ndarray) -> None:
        """Start a compaction epoch: ``ids`` are indexed by input row,
        which search results return; every row alive."""
        row_of = np.full(int(ids.max()) + 1 if ids.size else 0, -1, np.int64)
        row_of[ids] = np.arange(ids.size)
        self._main = _Main(index, ids, ids if index is None
                           else ids[to_numpy(index.orig_row)], row_of)
        self._main_alive = np.ones(ids.size, bool)
        self._removal = None

    def _main_view(self) -> _Removal:
        """The removal epoch, built at the first request after a removal
        of a main row (or a compaction): tombstones ride along as a
        leaf-major ``[N]`` bool mask folded into the scan."""
        if self._removal is None:
            COUNTERS["dynamic.main_views"] += 1
            with span("vdb_torch.dynamic.main_view"):
                index, alive = self._main.index, self._main_alive
                rows = mask = None
                if index is not None and alive.any():
                    rows = index.vectors
                    if not alive.all():
                        mask = torch.from_numpy(alive).to(self._device)[
                            index.orig_row]
                self._removal = _Removal(rows, mask)
        return self._removal

    def _invalidate_main(self) -> None:
        """Drop the removal epoch: the next request rebuilds it."""
        self._removal = None

    # --- size ---------------------------------------------------------
    def __len__(self) -> int:
        return int(self._main_alive.sum()) + self._delta.size

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
            # copied into the buffer: the caller may reuse its own
            self._delta.append(vectors, ids)
            COUNTERS["dynamic.rows_added"] += ids.size
        self._maybe_compact()
        return ids

    @spanned("vdb_torch.dynamic.remove")
    def remove(self, vector, radius: float) -> int:
        """Remove every row within ``radius`` of ``vector``; returns the
        number removed."""
        removed = 0
        r2 = np.float32(radius) ** 2
        index = self._main.index
        if index is not None:
            res = bsp_search(index, vector, radius)
            if bool(res.overflow[0]):
                # the walk's candidate buffer capped out: a truncated
                # answer would leave in-radius rows alive, so scan exactly
                d2 = to_numpy(exact_d2_blocked(vector, index.vectors))[0]
                rows = to_numpy(index.orig_row)[d2 <= r2]
            else:
                rows = to_numpy(res.rows[0])
                rows = rows[rows >= 0]
            hit = rows[self._main_alive[rows]]
            self._main_alive[hit] = False
            removed += hit.size
            if hit.size:
                self._invalidate_main()
        if self._delta.size:
            v = atleast_2d(as_f32(vector, self._device))
            # f32 radius square, like the compare on the main segment
            keep = to_numpy(torch.sum((self._delta.live - v) ** 2,
                                      dim=1)) > r2
            if not keep.all():
                removed += int((~keep).sum())
                self._delta.keep(keep)
        COUNTERS["dynamic.rows_removed"] += removed
        self._maybe_compact()
        return removed

    @spanned("vdb_torch.dynamic.remove")
    def remove_ids(self, ids) -> int:
        """Remove rows by external id; returns the number removed."""
        ids = np.unique(np.atleast_1d(to_numpy(ids)).astype(np.int64))
        row_of = self._main.row_of
        rows = row_of[ids[(ids >= 0) & (ids < row_of.size)]]
        rows = rows[rows >= 0]
        hit = rows[self._main_alive[rows]]
        self._main_alive[hit] = False
        removed = int(hit.size)
        if removed:
            self._invalidate_main()
        if self._delta.size:
            keep = ~np.isin(self._delta.ids, ids)
            if not keep.all():
                removed += int((~keep).sum())
                self._delta.keep(keep)
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
        index = self._main.index
        if index is not None:
            res = bsp_search(index, queries, radius)
            ovf = to_numpy(res.overflow)
            res_rows, res_d2 = to_numpy(res.rows), to_numpy(res.sq_dists)
            # overflowed queries would silently lose matches: re-answer
            # those few with one exact scan over the main segment
            sub_pos = {}
            if ovf.any():
                sub = np.nonzero(ovf)[0]
                exact_d2 = to_numpy(exact_d2_blocked(
                    queries[torch.from_numpy(sub).to(self._device)],
                    index.vectors,
                ))
                orig = to_numpy(index.orig_row)
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
                out[qi][0].extend(self._main.ids[rows[alive]].tolist())
                out[qi][1].extend(d2[alive].tolist())
        if self._delta.size:
            d2 = to_numpy(exact_d2_blocked(queries, self._delta.live))
            dids = self._delta.ids
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
        leaf_ids = self._main.leaf_ids
        allowed = None if allowed_ids is None else to_numpy(allowed_ids)
        if view.rows is not None:
            kk = min(k, leaf_ids.size)
            if packed:
                if view.pack is None:
                    with span("vdb_torch.dynamic.main_view"):
                        main = self._main
                        if main.pack is None:
                            main.pack = pack_database(view.rows)
                        view.pack = (main.pack if view.mask is None
                                     else main.pack.mask_rows(view.mask))
                rows, d2 = pallas_scan_knn_packed(
                    view.pack, q, k=kk, q_tile=q_tile,
                    oversample=oversample, probes=probes,
                    row_mask=view.mask,
                )
            else:
                row_mask = view.mask
                if allowed is not None:
                    amask = torch.from_numpy(
                        np.isin(leaf_ids, allowed)).to(self._device)
                    row_mask = amask if row_mask is None else row_mask & amask
                rows, d2 = scan_knn(
                    view.rows, q, k=kk,
                    precise=True if exact is None else exact,
                    row_mask=row_mask,
                )
            rows, d2 = to_numpy(rows), to_numpy(d2)
            ids = np.where(rows >= 0, leaf_ids[np.clip(rows, 0, None)], -1)
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

    @spanned("vdb_torch.dynamic.merge")
    def merge_delta(self, queries, ids, d2, k: int, *, allowed=None):
        """Merge the delta rows into a main-segment top-k ``(ids [Q, k],
        d2 [Q, k])``, on the index's device: the live delta rows' ``k``
        best by exact f32 distances (``delta_knn``; equal distances keep
        the earlier add), then one stable sort of main and delta
        together, so main rows lead delta rows on equal distances. Only
        the merged ``[Q, k]`` comes back to the host. Delta results are
        exact in every serving mode."""
        delta = self._delta
        if not delta.size:
            return ids, d2
        dev = delta.rows.device
        dids, slots = delta.merge_view()
        if allowed is not None:
            slots = torch.from_numpy(np.flatnonzero(np.isin(
                delta.ids, allowed)).astype(np.int32)).to(dev)
        COUNTERS["dynamic.delta_rows"] += slots.shape[0]
        COUNTERS["dynamic.delta_slots"] += delta.rows.shape[0]
        dd2, pos = delta_knn(atleast_2d(as_f32(queries, dev)), delta.rows,
                             slots, k)
        cat_d = torch.cat([
            torch.as_tensor(d2, dtype=torch.float32, device=dev), dd2], 1)
        # the kernel's empty places (+inf) hold slot -1; +inf gives id -1
        cat_i = torch.cat([
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            dids[pos.clamp(min=0)]], 1)
        d2, order = torch.sort(cat_d, dim=1, stable=True)
        d2 = d2[:, :k]
        ids = torch.where(torch.isfinite(d2), cat_i.gather(1, order[:, :k]),
                          -1)
        return to_numpy(ids), to_numpy(d2)

    # --- maintenance ----------------------------------------------------
    def _maybe_compact(self) -> None:
        main = max(1, self._main.ids.size)
        dead = main - int(self._main_alive.sum())
        churn = (self._delta.size + dead) / main
        if churn > self._rebuild_fraction and len(self) > 0:
            self.compact()

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint in the JAX package's format: compacts, then writes
        ``state.npz`` and ``index.npz``."""
        self.compact()
        os.makedirs(path, exist_ok=True)
        index = self._main.index
        np.savez_compressed(
            os.path.join(path, "state.npz"),
            main_ids=self._main.ids,
            next_id=np.int64(self._next_id),
            leaf_size=np.int64(self._leaf_size),
            rebuild_fraction=np.float64(self._rebuild_fraction),
            dims=np.int64(self._dims if self._dims is not None else -1),
            has_index=np.bool_(index is not None),
        )
        if index is not None:
            index.save(os.path.join(path, "index"))

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
            ids = z["main_ids"]
            has_index = bool(z["has_index"])
        index = (BSPIndex.load(os.path.join(path, "index.npz"),
                               device=out._device) if has_index else None)
        out._set_main(index, ids)
        return out

    @spanned("vdb_torch.dynamic.compact")
    def compact(self) -> None:
        """Rebuild the main tree over all live rows and clear the delta;
        a no-op when already compact (empty delta, no tombstones)."""
        main, alive, delta = self._main, self._main_alive, self._delta
        if not delta.size and main.index is not None and alive.all():
            return
        COUNTERS["dynamic.compactions"] += 1
        # the live main rows in leaf-major order (the JAX class's order,
        # so both build the same tree), then the delta in add order
        parts_v, parts_i = [], []
        if main.index is not None and alive.any():
            keep = alive[to_numpy(main.index.orig_row)]
            parts_v.append(main.index.vectors if keep.all() else
                           main.index.vectors[torch.from_numpy(keep).to(
                               self._device)])
            parts_i.append(main.leaf_ids[keep])
        if delta.size:
            parts_v.append(delta.live)
            parts_i.append(delta.ids)
        self._delta = _Delta()
        if not parts_v:
            self._set_main(None, np.zeros((0,), np.int64))
            return
        vecs = torch.cat(parts_v)  # a copy: the delta's buffer goes now
        del parts_v, delta
        self._set_main(build_index_fused(vecs, leaf_size=self._leaf_size),
                       np.concatenate(parts_i))
