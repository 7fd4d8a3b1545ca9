"""Fixed-batch serving front end over a packed database (port of
``vector_database_tpu/serving.py``): a single-device ``PackedDB`` or a
mesh-sharded ``ShardedPackedDB``, dispatched on the pack's type as in JAX.

Every caller batch is cut into ``batch``-sized waves and the last wave
padded, so every scan runs at one shape: the kernel's grid and the
selection's tensors never change size between calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vector_database_tpu_torch.ops.exact import as_f32, atleast_2d
from vector_database_tpu_torch.ops.packed_knn import (
    PackedDB,
    pack_database,
    pallas_scan_knn_packed,
    pallas_scan_knn_packed_rt,
)
from vector_database_tpu_torch.parallel.scan import sharded_scan_knn
from vector_database_tpu_torch.utils.profiling import COUNTERS, span, spanned


class PackedServer:
    """Fixed-batch serving front end for the packed scan.

    ``batch``: the wave size; larger caller batches are served in waves,
    smaller ones padded. ``k``, ``q_tile``, ``oversample``, ``probes``
    are the scan's parameters. ``probes`` enables the pruned mode: only
    that many blocks stream per query tile. Pruning is a batch mode: few
    query tiles share the probe budget badly, so ``min_probe_batch``
    serves waves with fewer real queries than this by the full scan
    (``min_probe_batch=batch`` prunes only full waves; larger values are
    rejected because no wave could satisfy them). ``probes_max`` serves
    the pruned waves through the runtime-probes path, and ``set_probes``
    retunes the operating point within ``[1, probes_max]``. Over a
    ``ShardedPackedDB`` every wave is the sharded scan (``probes`` per
    rank), and every rank of its mesh calls ``query`` with the same
    batches.

    >>> pack = pack_database(vectors, device="cuda")
    >>> srv = PackedServer(pack, k=10, batch=1024)
    >>> srv.warmup()
    >>> rows, d2 = srv.query(queries)
    """

    def __init__(
        self,
        pack: PackedDB,
        *,
        k: int = 10,
        batch: int = 1024,
        q_tile: Optional[int] = None,
        oversample: Optional[int] = None,
        probes: Optional[int] = None,
        probes_max: Optional[int] = None,
        min_probe_batch: Optional[int] = None,
    ):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if min_probe_batch is not None and probes is None:
            raise ValueError(
                "min_probe_batch only applies to pruned serving; set "
                "probes= as well"
            )
        if min_probe_batch is not None and min_probe_batch > batch:
            raise ValueError(
                f"min_probe_batch ({min_probe_batch}) exceeds batch "
                f"({batch}): no wave could ever satisfy it, so pruning "
                "would be silently disabled for all traffic; set "
                "min_probe_batch <= batch (batch itself prunes only "
                "full waves)"
            )
        if probes_max is not None and probes is None:
            raise ValueError("probes_max requires probes")
        self._pack = pack
        self._k = k
        self._batch = batch
        # the scan pads each wave up to q_tile: a default larger than the
        # batch would multiply the work per wave for nothing
        self._q_tile = (
            q_tile if q_tile is not None
            else min(512, max(8, -(-batch // 8) * 8))
        )
        self._oversample = oversample
        self._probes = probes
        self._probes_max = probes_max
        self._min_probe_batch = min_probe_batch
        # dispatch on the pack flavour (single-device vs mesh-sharded)
        self._sharded = not isinstance(pack, PackedDB)

    @classmethod
    def from_vectors(cls, vectors, *, k: int = 10, batch: int = 1024,
                     **pack_kw) -> "PackedServer":
        """Pack ``vectors`` once (``pack_database(**pack_kw)``, any of its
        forms: ``dtype="uint8"`` serves integer rows in [0, 255] exactly)
        and wrap the result; the steady-state serving constructor. The serve
        keywords (``q_tile``, ``oversample``, ``probes``, ``probes_max``,
        ``min_probe_batch``) are split off for the server."""
        serve_kw = {key: pack_kw.pop(key) for key in (
            "q_tile", "oversample", "probes", "probes_max",
            "min_probe_batch") if key in pack_kw}
        return cls(pack_database(vectors, **pack_kw), k=k, batch=batch,
                   **serve_kw)

    @property
    def batch(self) -> int:
        return self._batch

    @property
    def k(self) -> int:
        return self._k

    def set_probes(self, probes: int) -> None:
        """Retune the pruned operating point on a live server."""
        if self._probes is None:
            raise ValueError(
                "this server was built without probes=; construct a "
                "pruned server to tune one"
            )
        if self._probes_max is not None and probes > self._probes_max:
            raise ValueError(
                f"probes ({probes}) exceeds probes_max "
                f"({self._probes_max}); rebuild the server with a wider "
                "probes_max"
            )
        self._probes = probes

    def _serve(self, queries, pruned: bool):
        kw = dict(k=self._k, q_tile=self._q_tile,
                  oversample=self._oversample)
        if self._sharded:
            if pruned and self._probes_max is not None:
                kw["probes_max"] = self._probes_max
            return sharded_scan_knn(
                self._pack, queries, probes=self._probes if pruned else None,
                **kw,
            )
        if pruned and self._probes_max is not None:
            return pallas_scan_knn_packed_rt(
                self._pack, queries, self._probes,
                probes_max=self._probes_max, **kw,
            )
        return pallas_scan_knn_packed(
            self._pack, queries, probes=self._probes if pruned else None,
            **kw,
        )

    def warmup(self) -> None:
        """Run one full wave (and, with ``min_probe_batch``, one small
        full-scan wave) so that first-use costs, such as building the
        kernel, stay off the request path."""
        d = self._pack.vectors.shape[1]
        dev = self._pack.device
        self.query(torch.zeros((self._batch, d), device=dev))
        if self._min_probe_batch is not None and self._min_probe_batch > 1:
            self.query(torch.zeros((1, d), device=dev))

    @spanned("vdb_torch.serve.query")
    def query(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """k-NN for any number of queries at one wave shape: ``(rows
        [Q, k], scores [Q, k])`` on the pack's device: squared distances
        (l2/cosine) or exact dots, highest first (ip). Each wave is a
        ``vdb_torch.serve.wave`` span and counts its real queries and its
        ``batch`` slots (``serve.queries``, ``serve.slots``)."""
        queries = atleast_2d(as_f32(queries, self._pack.device))
        q = queries.shape[0]
        rows_out, d_out = [], []
        for lo in range(0, q, self._batch):
            with span("vdb_torch.serve.wave"):
                tile = queries[lo : lo + self._batch]
                real = tile.shape[0]
                COUNTERS["serve.queries"] += real
                COUNTERS["serve.slots"] += self._batch
                if real < self._batch:
                    tile = torch.nn.functional.pad(
                        tile, (0, 0, 0, self._batch - real)
                    )
                pruned = self._probes is not None and (
                    self._min_probe_batch is None
                    or real >= self._min_probe_batch
                )
                r, d2 = self._serve(tile, pruned)
                rows_out.append(r[:real])
                d_out.append(d2[:real])
        if not rows_out:
            dev = self._pack.device
            return (torch.zeros((0, self._k), dtype=torch.int64, device=dev),
                    torch.zeros((0, self._k), device=dev))
        return torch.cat(rows_out), torch.cat(d_out)
