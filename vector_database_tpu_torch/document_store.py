"""Document-scoped vector store (port of
``vector_database_tpu/document_store.py``).

Documents hold texts with one vector each; ``index_document`` (re)builds
a document's own index; ``search`` is epsilon-proximity over one document
or all of them. Batched serving (``search_batch``, ``knn_batch``) goes
through one store-wide index over every document's rows, with rows added
since its build held in a delta that is scanned exactly and merged, so
one ``add_text`` does not rebuild the store. ``save``/``load`` use the
JAX package's format (``manifest.json``, ``doc_*_vectors.npz``,
``doc_*_index.npz``), so a store saved by either package loads into the
other.

Host-facing methods return numpy arrays and Python lists, as the JAX
class does; indexes and serving tensors live on the store's ``device``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vector_database_tpu_torch.builder import build_index_fused
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.exact import exact_d2_blocked, to_numpy
from vector_database_tpu_torch.ops.packed_knn import (
    pack_database,
    pallas_scan_knn_packed,
)
from vector_database_tpu_torch.ops.scan_knn import scan_knn
from vector_database_tpu_torch.search import search as bsp_search
from vector_database_tpu_torch.utils.device import resolve_device


@dataclass
class _Document:
    doc_id: int
    name: str
    text_ids: List[int] = field(default_factory=list)
    texts: List[Optional[str]] = field(default_factory=list)
    vectors: List[np.ndarray] = field(default_factory=list)
    index: Optional[BSPIndex] = None
    dirty: bool = True  # texts changed since last index_document


class DocumentStore:
    """Documents -> texts (with vectors) -> per-document BSP indexes.

    ``device``: where indexes and serving tensors live (default: the
    card, ``cuda``)."""

    def __init__(self, leaf_size: int = 8, *, device=None):
        self._device = resolve_device(device)
        self._docs: Dict[int, _Document] = {}
        self._next_doc = 1
        self._next_text = 1
        self._leaf_size = leaf_size
        # store-wide serving index over every document's rows, rebuilt
        # only when the delta of later rows passes its threshold
        self._combined = None  # (index, owners, text ids) or Nones
        self._delta: List[Tuple[np.ndarray, int, int]] = []
        self.combined_builds = 0  # full rebuild count
        self._dims = None  # store-wide vector shape, set by first add
        # per-(combined build, doc_id) device slice for knn_batch, LRU
        # bounded: unbounded, the slices would add up to a second copy
        # of the store matrix on the device
        self._doc_slice: Dict[int, tuple] = {}
        self._doc_slice_cap = 4
        # host copy of the combined matrix and the store-row -> position
        # map, pulled once per combined build for doc-slice misses
        self._host_view = None
        # store-wide serving pack, built once per combined build
        self._packed_store = None

    # --- documents -------------------------------------------------------
    def create_document(self, name: str = "") -> int:
        doc_id = self._next_doc
        self._next_doc += 1
        self._docs[doc_id] = _Document(doc_id, name)
        return doc_id

    def delete_document(self, doc_id: int) -> None:
        """Cascade delete: texts and index go with the document."""
        del self._docs[doc_id]
        self._combined = None
        self._delta = []
        if not any(d.vectors for d in self._docs.values()):
            # an emptied store accepts any vector width again
            self._dims = None

    @property
    def documents(self) -> List[Tuple[int, str]]:
        return [(d.doc_id, d.name) for d in self._docs.values()]

    # --- texts -----------------------------------------------------------
    def add_text(
        self,
        doc_id: int,
        vector,
        text: Optional[str] = None,
        text_id: Optional[int] = None,
    ) -> int:
        doc = self._docs[doc_id]
        if text_id is None:
            text_id = self._next_text
        self._next_text = max(self._next_text, text_id + 1)
        vec = np.asarray(to_numpy(vector), dtype=np.float32)
        if doc.vectors and vec.shape != doc.vectors[0].shape:
            raise ValueError("invalid vector size")
        # store-wide check: the combined view concatenates every
        # document's rows, so a mismatch must fail here
        if self._dims is None:
            self._dims = vec.shape
        elif vec.shape != self._dims:
            raise ValueError(
                f"invalid vector size: store is {self._dims}, "
                f"got {vec.shape}"
            )
        doc.text_ids.append(text_id)
        doc.texts.append(text)
        doc.vectors.append(vec)
        doc.dirty = True
        if self._combined is not None and self._combined[0] is not None:
            # the new row joins the exactly scanned delta; rebuild only
            # when the delta outgrows its threshold
            self._delta.append((vec, doc_id, text_id))
            if len(self._delta) > max(64, self._combined[1].size // 4):
                self._combined = None
                self._delta = []
        else:
            self._combined = None
            self._delta = []
        return text_id

    def get_text(self, doc_id: int, text_id: int):
        doc = self._docs[doc_id]
        i = doc.text_ids.index(text_id)
        return doc.texts[i], doc.vectors[i]

    # --- per-document index ----------------------------------------------
    def index_document(self, doc_id: int) -> None:
        """(Re)build the document's index and swap it in."""
        doc = self._docs[doc_id]
        if not doc.vectors:
            doc.index = None
            doc.dirty = False
            return
        doc.index = build_index_fused(np.stack(doc.vectors),
                                      leaf_size=self._leaf_size,
                                      device=self._device)
        doc.dirty = False

    def search(
        self,
        point,
        domain: float,
        doc_id: Optional[int] = None,
        *,
        exact: bool = True,
        auto_index: bool = True,
    ) -> List[Tuple[int, int, float]]:
        """Epsilon-proximity search: ``(doc_id, text_id, sq_dist)`` rows.

        ``doc_id=None`` searches every document. ``exact=False`` returns
        the raw candidate superset with ``sq_dist = nan``. Dirty
        documents are reindexed first when ``auto_index``."""
        point = np.asarray(to_numpy(point), dtype=np.float32)
        targets = (
            [self._docs[doc_id]] if doc_id is not None
            else list(self._docs.values())
        )
        out: List[Tuple[int, int, float]] = []
        for doc in targets:
            if doc.dirty and auto_index:
                self.index_document(doc.doc_id)
            if doc.index is None:
                continue
            res = bsp_search(doc.index, point, domain)
            if exact:
                if bool(res.overflow[0]):
                    # candidate buffer at its growth cap: scan this
                    # document exactly instead
                    d2 = to_numpy(
                        exact_d2_blocked(point, doc.index.vectors))[0]
                    m = d2 <= domain * domain
                    rows, d2 = to_numpy(doc.index.orig_row)[m], d2[m]
                else:
                    rows = to_numpy(res.rows[0])
                    d2 = to_numpy(res.sq_dists[0])
                for r, dd in zip(rows, d2):
                    if r >= 0:
                        out.append(
                            (doc.doc_id, doc.text_ids[int(r)], float(dd))
                        )
            else:
                # the raw candidate superset: verification is the
                # caller's job
                cand = to_numpy(res.cand_rows[0])
                for r in cand[cand >= 0]:
                    out.append(
                        (doc.doc_id, doc.text_ids[int(r)], float("nan"))
                    )
        return out

    # --- batched serving over the whole store ----------------------------
    def _combined_view(self):
        """The store-wide index over every document's rows with
        ``(doc_id, text_id)`` per row, built lazily; rows added since
        live in the delta (``_delta_arrays``)."""
        if self._combined is None:
            # the per-doc slices and the pack die with the old build
            self._doc_slice = {}
            self._host_view = None
            self._packed_store = None
            mats, owners, tids = [], [], []
            for doc in self._docs.values():
                if not doc.vectors:
                    continue
                mats.append(np.stack(doc.vectors))
                owners.append(
                    np.full(len(doc.vectors), doc.doc_id, np.int64)
                )
                tids.append(np.asarray(doc.text_ids, np.int64))
            self._delta = []
            if not mats:
                self._combined = (None, None, None)
            else:
                index = build_index_fused(
                    np.concatenate(mats), leaf_size=self._leaf_size,
                    device=self._device,
                )
                self.combined_builds += 1
                self._combined = (
                    index,
                    np.concatenate(owners),
                    np.concatenate(tids),
                )
        return self._combined

    def _delta_arrays(self):
        """Rows added since the last combined build: ``(matrix [Nd, D],
        owners [Nd], text_ids [Nd])`` numpy arrays, or None."""
        if not self._delta:
            return None
        return (
            np.stack([v for v, _, _ in self._delta]),
            np.asarray([d for _, d, _ in self._delta], np.int64),
            np.asarray([t for _, _, t in self._delta], np.int64),
        )

    @staticmethod
    def _delta_sq_dists(points: np.ndarray, dmat: np.ndarray) -> np.ndarray:
        """Exact f32 squared distances of the queries to the delta rows
        (``[Q, Nd]``), shared by both serving entries."""
        diff = points[:, None, :] - dmat[None, :, :]
        return np.einsum("qnd,qnd->qn", diff, diff).astype(np.float32)

    def search_batch(
        self,
        points,
        domain: float,
        doc_id: Optional[int] = None,
    ) -> List[List[Tuple[int, int, float]]]:
        """Batched epsilon-proximity search of ``[Q, D]`` points against
        the whole store (or one document): per query, exact
        ``(doc_id, text_id, sq_dist)`` rows."""
        points = np.atleast_2d(np.asarray(to_numpy(points), np.float32))
        index, owners, tids = self._combined_view()
        if index is None:
            return [[] for _ in range(points.shape[0])]
        res = bsp_search(index, points, domain)
        rows = to_numpy(res.rows)
        d2 = to_numpy(res.sq_dists)
        # overflowed queries would silently miss matches: re-answer
        # those with one exact scan
        ovf = to_numpy(res.overflow)
        sub_pos = {}
        if ovf.any():
            sub = np.nonzero(ovf)[0]
            ex_d2 = to_numpy(exact_d2_blocked(points[sub], index.vectors))
            orig = to_numpy(index.orig_row)
            sub_pos = {int(qv): j for j, qv in enumerate(sub)}
        delta = self._delta_arrays()
        if delta is not None:
            dmat, downers, dtids = delta
            dd2 = self._delta_sq_dists(points, dmat)
        out: List[List[Tuple[int, int, float]]] = []
        for qi in range(points.shape[0]):
            if qi in sub_pos:
                m = ex_d2[sub_pos[qi]] <= domain * domain
                r = orig[m]
                dd = ex_d2[sub_pos[qi]][m]
            else:
                keep = rows[qi] >= 0
                r, dd = rows[qi][keep], d2[qi][keep]
            if doc_id is not None:
                sel = owners[r] == doc_id
                r, dd = r[sel], dd[sel]
            matches = list(zip(owners[r].tolist(), tids[r].tolist(),
                               dd.astype(float).tolist()))
            if delta is not None:
                hit = dd2[qi] <= domain * domain
                if doc_id is not None:
                    hit &= downers == doc_id
                matches.extend(zip(downers[hit].tolist(),
                                   dtids[hit].tolist(),
                                   dd2[qi][hit].astype(float).tolist()))
            out.append(matches)
        return out

    def _doc_view(self, index, owners, doc_id):
        """``(device matrix | None, store rows)`` of one document's rows
        in the combined build, cached per document (LRU)."""
        cached = self._doc_slice.pop(doc_id, None)
        if cached is None:
            if self._host_view is None:
                # store rows -> leaf-major positions; one host pull of
                # the matrix per combined build, shared by every miss
                pos_of = np.empty(owners.size, np.int64)
                pos_of[to_numpy(index.orig_row)] = np.arange(owners.size)
                self._host_view = (to_numpy(index.vectors), pos_of)
            host_mat, pos_of = self._host_view
            sel = np.nonzero(owners == doc_id)[0]
            mat = (torch.from_numpy(host_mat[pos_of[sel]]).to(self._device)
                   if sel.size else None)
            cached = (mat, sel)
            while len(self._doc_slice) >= self._doc_slice_cap:
                self._doc_slice.pop(next(iter(self._doc_slice)))
        self._doc_slice[doc_id] = cached  # LRU: back to newest
        return cached

    def knn_batch(
        self,
        points,
        k: int,
        doc_id: Optional[int] = None,
        *,
        exact: Optional[bool] = None,
        packed: bool = False,
        probes: Optional[int] = None,
        min_probe_batch: Optional[int] = None,
        q_tile: int = 256,
        oversample: Optional[int] = None,
    ):
        """Batched k-NN over the whole store (or one document): ``(doc_ids
        [Q, k], text_ids [Q, k], sq_dists [Q, k])``, -1 / +inf padding.
        ``exact=True`` (default) is the precise scan, ``exact=False`` the
        bf16 bucketed scan with an exact rerank. ``packed=True`` (whole
        store only) serves the combined index through the packed scan
        kernel, its pack built once per combined build; ``probes=`` adds
        block pruning, and ``min_probe_batch`` (default None, as in the
        JAX package) serves smaller calls by the full packed scan. Delta
        rows are always merged exactly."""
        points = np.atleast_2d(np.asarray(to_numpy(points), np.float32))
        nq = points.shape[0]
        if min_probe_batch is not None and probes is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if (probes is not None and min_probe_batch is not None
                and nq < min_probe_batch):
            probes = None  # under-filled batch: serve the full scan
        if packed and doc_id is not None:
            raise ValueError(
                "packed=True serves the whole store; per-document "
                "serving uses the doc-sliced exact scan (drop packed=)"
            )
        if packed and exact:
            raise ValueError(
                "packed=True serves the bf16 bucketed-scan accuracy "
                "model and cannot honor exact=True; drop one of them"
            )
        exact = True if exact is None else exact
        index, owners, tids = self._combined_view()
        if index is None:
            return (
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), np.inf, np.float32),
            )
        if doc_id is None:
            mat, orig = index.vectors, to_numpy(index.orig_row)
        else:
            mat, orig = self._doc_view(index, owners, doc_id)
        if orig.size == 0:
            # every row of this document lives in the delta; the merge
            # below supplies the results
            docs = np.full((nq, k), -1, np.int64)
            texts = np.full((nq, k), -1, np.int64)
            d2 = np.full((nq, k), np.inf, np.float32)
        else:
            q = torch.from_numpy(points).to(self._device)
            if packed:
                if (self._packed_store is None
                        or self._packed_store[0] is not index):
                    self._packed_store = (index, pack_database(mat))
                rows, d2 = pallas_scan_knn_packed(
                    self._packed_store[1], q, k=min(k, orig.size),
                    q_tile=q_tile, oversample=oversample, probes=probes,
                )
            else:
                rows, d2 = scan_knn(mat, q, k=min(k, orig.size),
                                    precise=exact)
            rows, d2 = to_numpy(rows), to_numpy(d2)
            if rows.shape[1] < k:
                pad = k - rows.shape[1]
                rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
                d2 = np.pad(d2, ((0, 0), (0, pad)), constant_values=np.inf)
            store_rows = np.where(rows >= 0, orig[np.clip(rows, 0, None)],
                                  -1)
            docs = np.where(store_rows >= 0,
                            owners[np.clip(store_rows, 0, None)], -1)
            texts = np.where(store_rows >= 0,
                             tids[np.clip(store_rows, 0, None)], -1)
        delta = self._delta_arrays()
        if delta is not None:
            # merge the exactly scanned delta rows into the top-k
            dmat, downers, dtids = delta
            dd2 = self._delta_sq_dists(points, dmat)
            if doc_id is not None:
                dd2 = np.where(downers[None, :] == doc_id, dd2, np.inf)
            cat_d = np.concatenate([d2, dd2], axis=1)
            cat_docs = np.concatenate(
                [docs, np.broadcast_to(downers[None, :], dd2.shape)], axis=1
            )
            cat_texts = np.concatenate(
                [texts, np.broadcast_to(dtids[None, :], dd2.shape)], axis=1
            )
            # stable: on equal distances main rows stay ahead, in order
            order = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
            d2 = np.take_along_axis(cat_d, order, 1)
            docs = np.where(
                np.isfinite(d2), np.take_along_axis(cat_docs, order, 1), -1
            )
            texts = np.where(
                np.isfinite(d2), np.take_along_axis(cat_texts, order, 1), -1
            )
        return docs, texts, d2

    # --- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        manifest = {
            "next_doc": self._next_doc,
            "next_text": self._next_text,
            "leaf_size": self._leaf_size,
            "documents": [],
        }
        for doc in self._docs.values():
            entry = {
                "doc_id": doc.doc_id,
                "name": doc.name,
                "text_ids": doc.text_ids,
                "texts": doc.texts,
                "dirty": doc.dirty,
                "has_index": doc.index is not None,
            }
            np.savez_compressed(
                os.path.join(path, f"doc_{doc.doc_id}_vectors.npz"),
                vectors=np.stack(doc.vectors) if doc.vectors
                else np.zeros((0, 0), np.float32),
            )
            if doc.index is not None:
                doc.index.save(os.path.join(path, f"doc_{doc.doc_id}_index"))
            manifest["documents"].append(entry)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    @classmethod
    def load(cls, path: str, *, device=None) -> "DocumentStore":
        """Load a store written by either package's ``save``, onto
        ``device`` (default: the card, ``cuda``)."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        store = cls(leaf_size=manifest["leaf_size"], device=device)
        store._next_doc = manifest["next_doc"]
        store._next_text = manifest["next_text"]
        for entry in manifest["documents"]:
            doc = _Document(entry["doc_id"], entry["name"])
            doc.text_ids = list(entry["text_ids"])
            doc.texts = list(entry["texts"])
            with np.load(os.path.join(
                    path, f"doc_{doc.doc_id}_vectors.npz")) as z:
                vecs = z["vectors"]
            doc.vectors = [vecs[i] for i in range(vecs.shape[0])]
            if entry["has_index"]:
                doc.index = BSPIndex.load(
                    os.path.join(path, f"doc_{doc.doc_id}_index.npz"),
                    device=store._device,
                )
            doc.dirty = entry["dirty"]
            store._docs[doc.doc_id] = doc
        # the store-wide width check survives the round trip
        for doc in store._docs.values():
            if doc.vectors:
                store._dims = doc.vectors[0].shape
                break
        return store
