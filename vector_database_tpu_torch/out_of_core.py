"""Out-of-core indexing: datasets larger than device memory (port of
``vector_database_tpu/out_of_core.py``).

The reference's scaling story is exactly this: the ~10M-vector build only
became feasible through a memory-mapped temp store after the in-RAM
parallel attempt died of page faults (reference README.md:91-98,
FileRangeStore.cs). Here:

- the dataset lives on the HOST (a ``NativeVectorStore`` mmap file or any
  row source);
- it is indexed in device-sized chunks: each chunk goes to the device,
  gets the fused build, is packed ONCE into the scan kernel's transposed
  bf16 block layout, and the finished per-chunk index (node tables,
  leaf-major vectors, packed blocks) returns to host RAM or a disk spill;
- queries send ONLY the per-chunk packed blocks and norm row to the
  device (``pallas_scan_knn_candidates`` per chunk, no repacking and no
  f32 matrix transfer); the exact f32 rerank gathers the few candidate
  rows per query from the host-side (possibly memmapped) chunk vectors,
  and the top-k / epsilon results merge across chunks. Merging is exact:
  every member of the global top-k is in its own chunk's top-k.

Chunks are padded to a uniform capacity (+inf sentinel rows the rerank
can never return, ``pack_database(rows_valid=...)``), so every chunk,
including a ragged final one, has the shapes of the first.

The packed blocks are kept on the host as the bits of their bf16 values
(``uint16``: numpy has no bf16), the JAX package's layout, so a directory
written by either package's ``save`` loads in the other.

Entry points run on the card (``cuda``) unless given ``device=``; the
tests pass ``device="cpu"``, where the scan kernel's plain version runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from vector_database_tpu_torch.builder import build_index_fused
from vector_database_tpu_torch.models.bsp import BSPIndex
from vector_database_tpu_torch.ops.bucket_scan import pad_rows
from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.ops.packed_knn import (
    PackedDB,
    pack_database,
    pallas_scan_knn_candidates,
    pallas_scan_knn_packed,
)
from vector_database_tpu_torch.search import search as bsp_search
from vector_database_tpu_torch.utils.device import resolve_device

_TABLE_KEYS = (
    "dim", "mid", "low", "high", "leaf_start", "leaf_count", "orig_row",
    "vn", "cent", "rad",
)
_SCALAR_KEYS = ("depth", "leaf_cap", "num_leaves", "cap", "n_real", "bits")
_NODE_KEYS = ("dim", "mid", "low", "high", "leaf_start", "leaf_count")


def _hbm_budget(device: torch.device) -> int:
    """Free memory for the chunk-prefetch and pin decisions: on the card
    what ``torch.cuda.mem_get_info`` reports free plus what PyTorch's
    caching allocator holds unused (it hands that out first); on the CPU
    device the host's free memory."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free + torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


# Device memory kept free past the pinned blocks for one serve call's
# transients at the serving batch (q = 4096 queries, m = 4096 buckets):
# the scan's [q_pad, m] f32 accumulator, then the full-row stable sort of
# it in _shortlist_rows, f32 values and int64 indices (64 + 64 + 128 MiB).
# The query tile and the [Q, k * oversample * block/m] shortlist are a few
# MiB beside them. The pinned host_rerank=True path sends nothing else.
_PIN_HEADROOM = 4096 * 4096 * (4 + 4 + 8)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` (which may be a read-only memmap) on ``device``: on the card
    copied into pinned host memory and sent from there with
    ``non_blocking=True`` on the current stream, so the transfer runs
    asynchronously; on the CPU a copy."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr))
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ChunkedIndex:
    """Host-resident index over device-sized chunks of a large dataset.

    Each chunk holds its BSP node tables (host RAM, the O(node-tables)
    bound), its leaf-major f32 vectors, and the scan kernel's packed bf16
    blocks, packed once at build time and reused by every batch.
    ``d_align=16`` keeps the packed stream at its minimum size: the
    streamed path moves every chunk's blocks per batch, and the kernel
    takes any ``d_pad`` that is a multiple of 16.

    ``spill_dir``: each chunk's vector matrix AND packed blocks are
    written to disk-backed ``.npy`` memmaps instead of host RAM; the
    chunks page in through the OS cache when a query sends them to the
    device. This bounds host RAM at O(node tables) whatever the dataset
    size (the reference's mmap temp store, FileRangeStore.cs, reborn as
    the serving-side spill). ``save``/``load`` stream the same arrays
    (``load`` maps them read-only), so a spilled index round-trips under
    the same RAM bound.

    ``device``: where chunks are built and served (default: the card).
    """

    def __init__(self, leaf_size: int = 16,
                 spill_dir: Optional[str] = None,
                 *,
                 block: int = 8192,
                 buckets: int = 4096,
                 d_align: int = 16,
                 metric: str = "l2",
                 device=None):
        self._leaf_size = leaf_size
        self._chunks: List[dict] = []  # host numpy tables + spillable rows
        self._offsets: List[int] = []
        self._n = 0
        self._d: Optional[int] = None
        self._spill = spill_dir
        self._block = block
        self._buckets = buckets
        self._d_align = d_align
        self._metric = metric
        self._device = resolve_device(device)
        self._capacity: Optional[int] = None
        self._pinned: Optional[list] = None
        # device copies of the per-chunk pruning summaries, made on the
        # first pruned call and kept: sending them again each call would
        # cost the pinned path, whose point is sending nothing per call
        self._summ_dev: dict = {}
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    @property
    def device(self) -> torch.device:
        return self._device

    # --- building ----------------------------------------------------------
    def _spill_npy(self, name: str, arr: np.ndarray) -> np.ndarray:
        path = os.path.join(self._spill, name)
        np.save(path, arr)
        del arr
        return np.load(path, mmap_mode="r")

    def add_chunk(self, vectors, capacity: Optional[int] = None) -> None:
        """Index and pack one chunk on the device and keep it on the host.

        ``capacity``: pad the chunk to this many rows (+inf sentinels) so
        that chunks of different sizes share one shape; it defaults to the
        first chunk's size, so a ragged FINAL chunk takes the full chunks'
        shape.
        """
        vectors = as_f32(vectors, self._device)
        if self._metric == "cosine":
            # normalize BEFORE the tree build so the per-chunk tree, the
            # rerank rows and the packed blocks all live in the same
            # (angular) space; pack_database's normalize is then a no-op
            norms = torch.linalg.vector_norm(vectors, dim=1, keepdim=True)
            vectors = vectors / torch.clamp(norms, min=1e-30)
        n = vectors.shape[0]
        if self._d is None:
            self._d = vectors.shape[1]
        elif vectors.shape[1] != self._d:
            raise ValueError("invalid vector size")
        if self._capacity is None:
            self._capacity = capacity if capacity else n
        cap = max(self._capacity, n, capacity or 0)

        index = build_index_fused(vectors, leaf_size=self._leaf_size)
        del vectors
        # pack ONCE from the leaf-major rows (+inf pads: the rerank can
        # never return them; rows_valid masks them out of bucket selection)
        padded = torch.cat([index.vectors, torch.full(
            (cap - n, self._d), float("inf"), device=self._device)])
        pack = pack_database(
            padded, block=self._block, buckets=self._buckets,
            d_align=self._d_align, metric=self._metric, rows_valid=n,
        )
        del padded
        vec = _host(pack.vectors)
        # the bf16 blocks as their bits, npy-safe (the JAX layout)
        vb = _host(pack.vb.contiguous().view(torch.int16)).view(np.uint16)
        orig = np.full((cap,), -1, np.int32)
        orig[:n] = _host(index.orig_row)
        if self._spill:
            i = len(self._chunks)
            vec = self._spill_npy(f"chunk{i}.npy", vec)
            vb = self._spill_npy(f"chunk{i}_vb.npy", vb)
        chunk = {key: _host(getattr(index, key)) for key in _NODE_KEYS}
        chunk.update({
            "vectors": vec,
            "vb": vb,
            "vn": _host(pack.vn.contiguous()),
            "orig_row": orig,
            "depth": index.depth,
            "leaf_cap": index.leaf_cap,
            "num_leaves": index.num_leaves,
            "cap": cap,
            "n_real": n,
            "bits": pack.bits,
            # pruning summaries (cell centroids and radii): kept on the
            # host, sent to the device on the first knn(probes=)
            "cent": _host(pack.cent),
            "rad": _host(pack.rad),
        })
        self._chunks.append(chunk)
        del index, pack
        self._offsets.append(self._n)
        self._n += n
        if self._pinned is not None:  # keep pinned serving consistent
            need = chunk["vb"].nbytes + chunk["vn"].nbytes + _PIN_HEADROOM
            if need > _hbm_budget(self._device):
                self.unpin()
                warnings.warn(
                    "add_chunk: new chunk's packed blocks exceed free "
                    "device memory; index unpinned (chunk added, serving "
                    "streams)"
                )
            else:
                try:
                    self._pinned.append(self._put_chunk(chunk, False))
                except Exception:
                    # never leave _pinned shorter than _chunks: every
                    # later knn() would IndexError on the last chunk
                    self.unpin()
                    raise

    @classmethod
    def from_store(cls, store, chunk_rows: int = 2_000_000,
                   leaf_size: int = 16,
                   spill_dir: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   **kwargs) -> "ChunkedIndex":
        """Build from a ``NativeVectorStore`` (or anything with
        ``.chunks(chunk_rows)``), one device-sized chunk at a time.

        ``checkpoint_dir``: mid-build durability. Each finished chunk's
        artifacts are persisted there (the ``save()`` format) and a
        manifest is atomically advanced; if the process dies, calling
        ``from_store`` again with the same arguments resumes AFTER the
        last completed chunk instead of from chunk 0 (the reference's
        per-document durability contract, DDL.sql:397-418, generalized to
        build time). The chunk payloads are re-memmapped from the
        checkpoint as they are written, so checkpointing subsumes
        ``spill_dir`` (ignored with a warning when both are given), and
        the finished directory is directly ``load()``-able. A manifest
        whose build parameters, store length or first rows disagree with
        the current call raises (a resumed build must produce the index a
        fresh one would). ``kwargs`` go to the constructor (``block``,
        ``buckets``, ``d_align``, ``metric``, ``device``)."""
        if checkpoint_dir is not None:
            if spill_dir is not None:
                warnings.warn(
                    "from_store: checkpoint_dir subsumes spill_dir "
                    "(chunk payloads are memmapped from the checkpoint); "
                    "spill_dir ignored"
                )
            return cls._from_store_checkpointed(
                store, chunk_rows, leaf_size, checkpoint_dir, **kwargs
            )
        out = cls(leaf_size=leaf_size, spill_dir=spill_dir, **kwargs)
        cap = _capacity(store, chunk_rows)
        for chunk in store.chunks(chunk_rows):
            out.add_chunk(chunk, capacity=cap)
        return out

    @classmethod
    def _from_store_checkpointed(cls, store, chunk_rows, leaf_size,
                                 path, **kwargs):
        out = cls(leaf_size=leaf_size, **kwargs)
        cap = _capacity(store, chunk_rows)
        params = {
            "chunk_rows": chunk_rows,
            "leaf_size": leaf_size,
            "block": out._block,
            "buckets": out._buckets,
            "d_align": out._d_align,
            "metric": out._metric,
        }
        os.makedirs(path, exist_ok=True)
        manifest_path = os.path.join(path, "resume.json")
        done = 0
        # identity of the DATA, not just the build parameters: resuming
        # against a different or grown store would mix chunks of two
        # datasets (and a changed len(store) changes the ragged final
        # chunk's capacity), so record the store length and a content
        # fingerprint (the first rows of chunk 0) and raise on mismatch
        n_store = len(store) if hasattr(store, "__len__") else None
        fingerprint = None
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                man = json.load(f)
            if man.get("params") != params:
                raise ValueError(
                    "checkpoint_dir holds a build with different "
                    f"parameters ({man.get('params')} vs {params}); "
                    "point at a fresh directory or match the original "
                    "arguments"
                )
            if man.get("n_store", n_store) != n_store:
                raise ValueError(
                    "checkpoint_dir holds a build over a store of "
                    f"{man.get('n_store')} rows but the current store "
                    f"has {n_store}; a resumed build must see the same "
                    "data a fresh one would: point at a fresh "
                    "directory (or the original store)"
                )
            fingerprint = man.get("fingerprint")
            done = int(man["chunks_done"])
            out._capacity = man["capacity"]
            out._d = man["d"]
            for i in range(done):
                out._chunks.append(cls._load_chunk(path, i))
                out._offsets.append(out._n)
                out._n += out._chunks[-1]["n_real"]

        def advance():
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "params": params,
                    "chunks_done": len(out._chunks),
                    "capacity": out._capacity,
                    "d": out._d,
                    "n_store": n_store,
                    "fingerprint": fingerprint,
                }, f)
            os.replace(tmp, manifest_path)  # atomic on POSIX

        for i, chunk in enumerate(store.chunks(chunk_rows)):
            if i == 0:
                # the head of chunk 0: the store yields it on a resume
                # too, so this costs nothing extra
                head = np.ascontiguousarray(np.asarray(chunk)[:64],
                                            np.float32)
                h = hashlib.sha1(head.tobytes()).hexdigest()
                if fingerprint is not None and fingerprint != h:
                    raise ValueError(
                        "checkpoint_dir holds a build over DIFFERENT "
                        "data (chunk-0 fingerprint mismatch); a resumed "
                        "build must see the same store a fresh one "
                        "would: point at a fresh directory"
                    )
                fingerprint = h
            if i < done:
                continue  # host-side skip: no device work repeated
            out.add_chunk(chunk, capacity=cap)
            out._persist_chunk(path, len(out._chunks) - 1, adopt=True)
            advance()
        # the finished directory doubles as a save(): write the final
        # meta.json so ChunkedIndex.load(checkpoint_dir) just works
        out._write_meta(path)
        return out

    def __len__(self) -> int:
        return self._n

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    def _device_index(self, c: dict) -> BSPIndex:
        return BSPIndex.from_numpy(
            {**{key: c[key] for key in _NODE_KEYS},
             "vectors": np.array(c["vectors"]), "orig_row": c["orig_row"]},
            [c["depth"], c["leaf_cap"], c["num_leaves"]],
            device=self._device,
        )

    def _device_pack(self, bufs: tuple, c: dict,
                     vectors=None, summaries=None) -> PackedDB:
        """The device ``PackedDB`` from a chunk's device buffers.
        ``vectors`` overrides the rerank source (the candidates-only path
        passes a ``[0, D]`` placeholder: the scan never reads it);
        ``summaries`` is the device ``(cent, rad)`` pair when the call
        serves pruned (``probes=``)."""
        vec = bufs[2] if vectors is None else vectors
        cent, rad = summaries if summaries is not None else (None, None)
        return PackedDB(
            vb=bufs[0], vn=bufs[1], vectors=vec,
            n=c["cap"], block=self._block,
            m=min(self._buckets, self._block), bits=c["bits"],
            metric=self._metric, cent=cent, rad=rad,
        )

    def _put_chunk(self, c: dict, with_vectors: bool = True) -> tuple:
        """A chunk's device buffers ``(vb, vn[, vectors])`` on the current
        stream. The blocks go as their int16 bits and are viewed as bf16
        on the device (no copy): they land already typed, so serving pays
        no per-call conversion; rows of a block that is no multiple of 16
        wide are laid out as the kernel reads them (``pad_rows``)."""
        bits = np.asarray(c["vb"]).view(np.int16)
        bufs = [
            pad_rows(_to_device(bits, self._device).view(torch.bfloat16)),
            pad_rows(_to_device(c["vn"], self._device)),
        ]
        if with_vectors:
            bufs.append(_to_device(c["vectors"], self._device))
        return tuple(bufs)

    # --- pinned serving ----------------------------------------------------
    def pin(self) -> None:
        """Keep every chunk's packed blocks and norm row resident in
        device memory, so ``knn(host_rerank=True)`` serves with NO
        per-call chunk transfer: the single-card CAPACITY serving mode.

        With the f32 rerank matrix staying on the host, the device holds
        only the blocks and norms (``2 * d_pad + 4`` bytes a row, against
        ``4 * d`` more with the on-device rerank), so one card serves
        about three times the rows of the fully resident path at d = 96.
        The exact rerank pages candidate rows from the host-side (possibly
        memmapped) vectors per batch.

        Raises if the packed blocks (plus the serving transients'
        headroom) exceed the free device memory. Pinning is a serving
        state, not part of ``save``. ``knn(host_rerank=False)`` on a
        pinned index additionally sends each chunk's f32 rerank matrix per
        call (double-buffered): budget about two chunks of vectors of
        extra device memory for that combination, or serve pinned with the
        default ``host_rerank=True``.
        """
        if self._pinned is not None:
            return
        need = _PIN_HEADROOM + sum(
            c["vb"].nbytes + c["vn"].nbytes for c in self._chunks
        )
        budget = _hbm_budget(self._device)
        if need > budget:
            raise ValueError(
                f"packed blocks ({need >> 20} MiB) exceed free device "
                f"memory (~{budget >> 20} MiB); serve unpinned (streamed)"
            )
        self._pinned = [self._put_chunk(c, False) for c in self._chunks]

    def unpin(self) -> None:
        """Release the pinned device buffers (back to streamed serving),
        and any cached device summaries with them."""
        self._summ_dev = {}
        self._pinned = None

    def _host_rerank(self, c: dict, short: np.ndarray, qh: np.ndarray,
                     k: int):
        """Exact f32 rerank of the kernel's candidate shortlist on the
        HOST, gathering only the O(Q * k_scan * w) candidate rows from the
        (possibly memmapped) chunk vectors: the out-of-core twin of the
        device rerank tail of ``_scan_knn_packed_impl``. ``qh`` must be in
        the chunk's metric space (unit rows for cosine). numpy, line for
        line the JAX package's, so the results are the same."""
        capn = c["cap"]
        ip = self._metric == "ip"
        safe = np.clip(short, 0, capn - 1)
        # memmap fancy indexing pages in only the candidate rows
        cand = c["vectors"][safe]  # [Q, C, D] f32
        with np.errstate(invalid="ignore", over="ignore"):
            if ip:
                key = -np.einsum("qcd,qd->qc", cand, qh)
            else:
                # in place: fancy indexing returned an owned array, and a
                # second [Q, C, D] temporary would cost a quarter of this
                # function's time. The dot form |c|^2 - 2qc + |q|^2 is
                # faster still but not exact: this rerank is the serving
                # path's exactness contract.
                cand -= qh[:, None, :]
                key = np.einsum("qcd,qcd->qc", cand, cand)
            # mask index pads AND +inf sentinel rows (isfinite catches
            # the ip -inf/NaN case, as the device rerank does)
            key = np.where((short < capn) & np.isfinite(key), key, np.inf)
        kk = min(k, key.shape[1])
        pos = np.argpartition(key, kk - 1, axis=1)[:, :kk]
        pkey = np.take_along_axis(key, pos, 1)
        order = np.argsort(pkey, axis=1, kind="stable")
        pkey = np.take_along_axis(pkey, order, 1)
        rows = np.take_along_axis(
            np.take_along_axis(short, pos, 1), order, 1
        )
        rows = np.where(np.isfinite(pkey), rows, -1)
        if k > kk:
            rows = np.pad(rows, ((0, 0), (0, k - kk)), constant_values=-1)
            pkey = np.pad(
                pkey, ((0, 0), (0, k - kk)), constant_values=np.inf
            )
        if ip:
            return rows, np.where(
                np.isfinite(pkey), -pkey, -np.inf
            ).astype(np.float32)
        return rows, pkey.astype(np.float32)

    def _chunk_serve_kw(self, i: int, c: dict, serve_kw: dict,
                        pruned: bool):
        """Per-chunk serve kwargs and cached device summaries for pruned
        serving (``probes >= nb`` is the exact full scan, the single-card
        probes contract)."""
        if not pruned:
            return serve_kw, None
        nb_c = c["vb"].shape[0]
        if serve_kw["probes"] >= nb_c:
            return (
                {x: v for x, v in serve_kw.items() if x != "probes"},
                None,
            )
        if c.get("cent") is None:
            raise ValueError(
                "probes= needs per-chunk summaries; this index "
                "was saved before they existed: rebuild it"
            )
        summ = self._summ_dev.get(i)
        if summ is None:
            summ = (
                torch.as_tensor(np.array(c["cent"]), device=self._device),
                torch.as_tensor(np.array(c["rad"]), device=self._device),
            )
            self._summ_dev[i] = summ
        return serve_kw, summ

    @staticmethod
    def _merge_chunk(best_d, best_r, rows, d2, c, off, k, ip, worst):
        """Fold one chunk's (rows, d2) into the running global top-k;
        exact: every member of the global top-k is in its chunk's top-k.
        The sort is stable, so on equal scores the earlier chunk's (and
        within a chunk the earlier) row stays first (the JAX package's
        unstable ``argsort`` may order such ties either way)."""
        orig_taken = c["orig_row"][np.where(rows >= 0, rows, 0)]
        valid = (rows >= 0) & (orig_taken >= 0)
        grows = np.where(valid, orig_taken + off, -1)
        cat_d = np.concatenate([best_d, np.where(valid, d2, worst)], 1)
        cat_r = np.concatenate([best_r, grows], 1)
        order = np.argsort(-cat_d if ip else cat_d, axis=1,
                           kind="stable")[:, :k]
        return (
            np.take_along_axis(cat_d, order, 1),
            np.take_along_axis(cat_r, order, 1),
        )

    # --- queries -----------------------------------------------------------
    def knn(self, queries, k: int, host_rerank: bool = True,
            min_probe_batch: Optional[int] = None, **serve_kw):
        """Global k-NN: per-chunk packed scan + exact host merge.

        Returns numpy ``(rows [Q, k], sq_dists [Q, k])`` with global row
        ids (for ``metric="ip"`` exact dots, highest first). ``serve_kw``
        goes to the scan (``q_tile``, ``oversample``, ``probes``).

        ``probes=`` serves each chunk PRUNED: only that many of the
        chunk's blocks are scanned per query group (cell-centroid
        selection; see ``pallas_scan_knn_packed``). On the streamed path
        this cuts nothing of the transfer (the whole chunk still goes to
        the device), but on a ``pin()``-ned index it divides the kernel
        time. Pruning is a BATCH mode: probes calibrated on a large batch
        lose recall on small ones (each query group of ``q_tile`` shares
        one block list). ``min_probe_batch`` guards it: calls with fewer
        queries serve the full scan. It defaults to None (no guard), as
        in ``DynamicIndex.knn``: the right floor is the batch the probes
        were calibrated at, which only the caller knows.

        ``host_rerank`` (default): only the packed bf16 blocks and the
        norm row go to the device (``2 * d_pad + 4`` bytes a row, a third
        of what the f32 rerank matrix would add at d = 96) in a path that
        is transfer-bound by definition, and the exact f32 rerank gathers
        the few candidate rows per query from the host-side chunk vectors.
        ``host_rerank=False`` reranks on the device.

        On a pinned index with ``host_rerank`` the chunks are pipelined:
        every chunk's scan is launched, and its shortlist copied to pinned
        host memory behind an event, before the first host rerank; each
        rerank waits on its chunk's event. Merge order is unchanged, so
        the results equal the sequential loop's bit for bit (the
        environment variable ``VDB_PIN_PIPELINE=0`` selects that loop, for
        A/B runs).
        """
        dev = self._device
        queries = atleast_2d(as_f32(queries, dev))
        q = queries.shape[0]
        if min_probe_batch is not None and serve_kw.get("probes") is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if (
            serve_kw.get("probes") is not None
            and min_probe_batch is not None
            and q < min_probe_batch
        ):
            serve_kw = {x: v for x, v in serve_kw.items() if x != "probes"}
        # ip scores are dots (HIGHER is better, returned best-first);
        # l2/cosine are squared distances (lower is better)
        ip = self._metric == "ip"
        worst = -np.inf if ip else np.inf
        best_d = np.full((q, k), worst, np.float32)
        best_r = np.full((q, k), -1, np.int64)
        qh = _host(queries)
        if host_rerank and self._metric == "cosine":
            # the host rerank scores in the chunk's metric space (rows
            # were unit-normalized at add_chunk)
            norms = np.linalg.norm(qh, axis=1, keepdims=True)
            qh = qh / np.maximum(norms, 1e-30)
        wv = not host_rerank
        placeholder = torch.empty((0, self._d or 0), device=dev)
        pruned = serve_kw.get("probes") is not None

        def merge(i, rows, d2):
            nonlocal best_d, best_r
            c = self._chunks[i]
            best_d, best_r = self._merge_chunk(
                best_d, best_r, rows, d2, c, self._offsets[i], k, ip, worst)

        def shortlist(i, bufs):
            c = self._chunks[i]
            kw, summ = self._chunk_serve_kw(i, c, serve_kw, pruned)
            pack = self._device_pack(bufs, c, vectors=placeholder,
                                     summaries=summ)
            return pallas_scan_knn_candidates(pack, queries, k=k, **kw)

        if (
            self._pinned is not None and host_rerank
            and os.environ.get("VDB_PIN_PIPELINE", "1") != "0"
        ):
            # CAPACITY-mode pipeline: every chunk's scan is launched and
            # its [Q, C] shortlist put on an async copy to pinned host
            # memory, with an event, BEFORE any host rerank runs: the
            # launches, the scans and the copies overlap the host gather
            # + exact rerank of earlier chunks
            pending = []
            for i in range(len(self._chunks)):
                s = shortlist(i, self._pinned[i])
                done = None
                if dev.type == "cuda":
                    host = torch.empty(s.shape, dtype=s.dtype,
                                       pin_memory=True)
                    host.copy_(s, non_blocking=True)
                    s, done = host, torch.cuda.Event()
                    done.record()
                pending.append((s, done))
            for i, (s, done) in enumerate(pending):
                if done is not None:
                    done.synchronize()  # the copy has landed in `s`
                pending[i] = None
                merge(i, *self._host_rerank(self._chunks[i], s.numpy(),
                                            qh, k))
            return best_r, best_d
        # Pinned chunks (pin()) skip the transfer entirely; otherwise
        # double-buffer it when device memory allows: chunk i+1 goes up on
        # a side stream while chunk i is scanned and reranked.
        pinned = self._pinned
        if pinned is None:
            chunk_bytes = max(
                (
                    c["vb"].nbytes + c["vn"].nbytes
                    + (c["vectors"].nbytes if wv else 0)
                    for c in self._chunks
                ),
                default=0,
            )
        else:  # pinned holds vb + vn only: the f32 rerank matrices go up
            chunk_bytes = max((c["vectors"].nbytes for c in self._chunks),
                              default=0) if wv else 0
        stream = _Prefetch(self, pinned, wv, chunk_bytes > 0
                           and 3 * chunk_bytes < _hbm_budget(dev))
        for i in range(len(self._chunks)):
            cur = stream.take(i)
            c = self._chunks[i]
            if host_rerank:
                s = shortlist(i, cur)
                stream.ahead(i)  # the host copy of the next chunk
                rows, d2 = self._host_rerank(c, _host(s), qh, k)
            else:
                kw, summ = self._chunk_serve_kw(i, c, serve_kw, pruned)
                pack = self._device_pack(cur, c, summaries=summ)
                rows, d2 = pallas_scan_knn_packed(pack, queries, k=k, **kw)
                stream.ahead(i)
                rows, d2 = _host(rows), _host(d2)
            del cur
            merge(i, rows, d2)
        return best_r, best_d

    def search(self, queries, radius: float):
        """Exact epsilon-ball over all chunks (tree walk per chunk);
        returns per-query ``(global_rows, sq_dists)`` numpy pairs.

        With ``metric="cosine"`` the ball is ANGULAR: rows were L2-
        normalized at ``add_chunk`` and queries are normalized here, so
        ``radius`` bounds the Euclidean distance between unit vectors
        (monotone in angle), the space ``knn`` scores in.
        ``metric="ip"`` has no epsilon-ball (inner product is not a
        metric).
        """
        if self._metric == "ip":
            raise ValueError(
                "search() is an epsilon-ball; inner product is not a "
                "metric: use knn()"
            )
        queries = atleast_2d(as_f32(queries, self._device))
        if self._metric == "cosine":
            norms = torch.linalg.vector_norm(queries, dim=1, keepdim=True)
            queries = queries / torch.clamp(norms, min=1e-30)
        out = [([], []) for _ in range(queries.shape[0])]
        for c, off in zip(self._chunks, self._offsets):
            res = bsp_search(self._device_index(c), queries, radius)
            # two transfers per chunk, not two per query
            all_rows = _host(res.rows)
            all_d2 = _host(res.sq_dists)
            for qi in range(queries.shape[0]):
                rows, d2 = all_rows[qi], all_d2[qi]
                keep = rows >= 0
                out[qi][0].extend((rows[keep] + off).tolist())
                out[qi][1].extend(d2[keep].tolist())
        return [
            (np.asarray(r, np.int64), np.asarray(d, np.float32))
            for r, d in out
        ]

    # --- persistence -------------------------------------------------------
    def _persist_chunk(self, path: str, i: int,
                       adopt: bool = False) -> None:
        """Write chunk ``i``'s artifacts in the ``save()`` layout.
        ``adopt=True`` (the checkpointed build) additionally re-memmaps
        the big arrays from what was just written, so the build's RAM
        stays O(node tables) like a spilled one."""
        c = self._chunks[i]
        np.savez(
            os.path.join(path, f"chunk_{i}_tables.npz"),
            # cent/rad may be None on chunks reloaded from an older
            # save: re-saving keeps them absent
            **{k: np.asarray(c[k]) for k in _TABLE_KEYS
               if c.get(k) is not None},
            scalars=np.array(
                [c[k] for k in _SCALAR_KEYS], np.int64
            ),
        )
        # np.save streams from a memmap source page by page: host RAM
        # stays O(buffer), not O(chunk)
        for key, fname in (("vectors", f"chunk_{i}_vectors.npy"),
                           ("vb", f"chunk_{i}_vb.npy")):
            dst = os.path.join(path, fname)
            src = c[key]
            # already memmapped from this very file (save() onto its own
            # checkpoint or load directory): rewriting a file that backs
            # an open read-mapping of itself would corrupt it, and it is
            # a no-op
            if getattr(src, "filename", None) is not None and \
                    os.path.exists(dst) and os.path.samefile(
                        src.filename, dst):
                continue
            np.save(dst, src)
            if adopt:
                c[key] = np.load(dst, mmap_mode="r")

    @staticmethod
    def _load_chunk(path: str, i: int) -> dict:
        z = np.load(os.path.join(path, f"chunk_{i}_tables.npz"))
        # cent/rad are absent from saves made before pruning existed:
        # load them as None (knn(probes=) then raises with a rebuild hint)
        chunk = {
            k: (z[k] if k in z.files else None) for k in _TABLE_KEYS
        }
        chunk.update(
            {k: int(v) for k, v in zip(_SCALAR_KEYS, z["scalars"])}
        )
        chunk["vectors"] = np.load(
            os.path.join(path, f"chunk_{i}_vectors.npy"), mmap_mode="r"
        )
        chunk["vb"] = np.load(
            os.path.join(path, f"chunk_{i}_vb.npy"), mmap_mode="r"
        )
        return chunk

    def _write_meta(self, path: str) -> None:
        meta = {
            "format": 2,
            "leaf_size": self._leaf_size,
            "offsets": self._offsets,
            "n": self._n,
            "d": self._d,
            "chunks": len(self._chunks),
            "block": self._block,
            "buckets": self._buckets,
            "d_align": self._d_align,
            "metric": self._metric,
            "capacity": self._capacity,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def save(self, path: str) -> None:
        """Durable copy of the index (the reference's ``dbo.TextIndex``
        role, DDL.sql:209-227), in the JAX package's format 2. The big
        per-chunk arrays (vectors, packed block bits) are streamed to
        plain ``.npy`` files (a spilled index saves without ever
        materializing a chunk in RAM) and the small node tables go into
        one npz per chunk."""
        os.makedirs(path, exist_ok=True)
        self._write_meta(path)
        for i in range(len(self._chunks)):
            self._persist_chunk(path, i)

    @classmethod
    def load(cls, path: str, *, device=None) -> "ChunkedIndex":
        """Reload a directory written by either package's ``save`` (or a
        finished ``checkpoint_dir``), to serve on ``device`` (default: the
        card). The big arrays are memory-mapped read-only, so a
        spilled-scale index serves under the O(node-tables) host RAM bound
        it was built under."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != 2:
            raise ValueError(
                "unrecognized ChunkedIndex save format; rebuild with "
                "this version's save()"
            )
        out = cls(
            leaf_size=meta["leaf_size"], block=meta["block"],
            buckets=meta["buckets"], d_align=meta["d_align"],
            metric=meta["metric"], device=device,
        )
        out._offsets = list(meta["offsets"])
        out._n = meta["n"]
        out._d = meta["d"]
        out._capacity = meta["capacity"]
        for i in range(meta["chunks"]):
            out._chunks.append(cls._load_chunk(path, i))
        return out


def _capacity(store, chunk_rows: int) -> int:
    """The chunk capacity of a build from ``store``: ``chunk_rows``, or
    the store's length where that is smaller. A store smaller than one
    chunk must not be padded up to ``chunk_rows`` (+inf sentinel rows
    cost device memory and scan time forever); larger stores keep the
    uniform capacity."""
    cap = min(chunk_rows, len(store)) if hasattr(store, "__len__") \
        else chunk_rows
    return max(cap, 1)


class _Prefetch:
    """The per-chunk device buffers of one ``knn`` call that does not
    pipeline: the pinned buffers, or the streamed ones, double-buffered
    when ``prefetch`` (device memory holds three chunks): chunk ``i+1``
    goes up on a side stream while chunk ``i`` is served. The caller's
    stream waits for the side stream before it uses a prefetched chunk,
    and each prefetched tensor is recorded on the caller's stream, so the
    caching allocator does not hand its memory out again while a scan on
    that stream may still read it. ``wv``: the f32 rerank matrices go up
    too (beside the pinned blocks, when pinned)."""

    def __init__(self, index: ChunkedIndex, pinned, wv: bool,
                 prefetch: bool):
        self._index = index
        self._pinned = pinned
        self._wv = wv
        dev = index.device
        self._side = torch.cuda.Stream(dev) \
            if prefetch and dev.type == "cuda" else None
        self._prefetch = prefetch
        self._next = None  # (i, bufs) put up ahead of its turn

    def _put(self, i: int) -> tuple:
        c = self._index._chunks[i]
        if self._pinned is None:
            return self._index._put_chunk(c, self._wv)
        return (_to_device(c["vectors"], self._index.device),)

    def take(self, i: int) -> tuple:
        """Chunk ``i``'s buffers, ready for the caller's stream."""
        if self._next is not None and self._next[0] == i:
            bufs = self._next[1]
            self._next = None
            if self._side is not None:
                main = torch.cuda.current_stream(self._index.device)
                main.wait_stream(self._side)
                for t in bufs:
                    t.record_stream(main)
        elif self._pinned is None or self._wv:
            bufs = self._put(i)
        else:
            bufs = ()
        return bufs if self._pinned is None else self._pinned[i] + bufs

    def ahead(self, i: int) -> None:
        """Send chunk ``i+1`` up now, if prefetching, while the caller
        finishes chunk ``i``."""
        if not self._prefetch or i + 1 >= len(self._index._chunks):
            return
        if self._side is None:
            self._next = (i + 1, self._put(i + 1))
            return
        with torch.cuda.stream(self._side):
            self._next = (i + 1, self._put(i + 1))
