"""The plain live-set reference of a mutable k-NN collection.

Rows are kept by id: ``add`` gives each new row the next integer id,
from 0, and ``remove_ids`` retires ids. Every mutation is one version,
and each id is live from the version of its add to the version of its
removal, so ``knn`` and ``live`` answer for the set as it is now or as
it was at any earlier version (``at``: one version, or one a query).
``knn`` is exact: squared Euclidean distances in float64 over the rows
live at that version, nearest first, lower id first on equal distances.

Plain PyTorch only: nothing here imports the program or JAX, and float32
matrix products never run in TF32 here (the screen is float64 anyway).
"""

from __future__ import annotations

import contextlib

import torch

_INF = float("inf")
_NEVER = torch.iinfo(torch.int64).max  # the version of a live id's removal


@contextlib.contextmanager
def full_precision():
    """TF32 off for matrix products and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class LiveSet:
    """Rows by id, each with the versions of its add and of its removal.

    The rows given to ``add`` are kept as they are (not copied) and read
    in float64. ``device``: where the versions live and the distances are
    computed (default: the device of the first rows added)."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.version = 0
        self._parts = []  # row blocks in id order
        self._rows = None  # their concatenation, made when first needed
        self._born = torch.zeros(0, dtype=torch.int64, device=self.device)
        self._died = torch.zeros(0, dtype=torch.int64, device=self.device)

    @property
    def size(self) -> int:
        """Ids given out so far (live or removed)."""
        return self._born.numel()

    def add(self, rows) -> torch.Tensor:
        """Insert ``rows`` ``[m, d]``; returns their ids ``[m]``."""
        rows = torch.as_tensor(rows, device=self.device)
        if self.device is None:
            self.device = rows.device
            self._born = self._born.to(self.device)
            self._died = self._died.to(self.device)
        m = rows.shape[0]
        ids = torch.arange(self.size, self.size + m, device=self.device)
        self._parts.append(rows)
        self._rows = None
        self._born = torch.cat([self._born, torch.full(
            (m,), self.version, dtype=torch.int64, device=self.device)])
        self._died = torch.cat([self._died, torch.full(
            (m,), _NEVER, dtype=torch.int64, device=self.device)])
        self.version += 1
        return ids

    def remove_ids(self, ids) -> int:
        """Retire the live ids among ``ids``; returns how many there were."""
        ids = torch.as_tensor(ids, dtype=torch.int64,
                              device=self.device).reshape(-1)
        ids = torch.unique(ids[(ids >= 0) & (ids < self.size)])
        hit = ids[self._died[ids] == _NEVER]
        self._died[hit] = self.version
        self.version += 1
        return int(hit.numel())

    def live(self, at=None) -> torch.Tensor:
        """``[size]`` bool: the ids live at version ``at`` (default now)."""
        v = self.version if at is None else int(at)
        return (self._born <= v) & (v < self._died)

    def is_live(self, ids, at=None) -> torch.Tensor:
        """Bool, ``ids``' shape: each id live at version ``at`` (one
        version, or one a row of ``ids``; default now); False for an id
        never given out."""
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        ok = (ids >= 0) & (ids < self.size)
        safe = ids.clamp(0, max(self.size - 1, 0))
        v = self._versions(at, ids.shape[0]).reshape(
            -1, *([1] * (ids.dim() - 1)))
        return ok & (self._born[safe] <= v) & (v < self._died[safe])

    def rows(self) -> torch.Tensor:
        """``[size, d]``: every row added, by id."""
        if self._rows is None:
            self._rows = (self._parts[0] if len(self._parts) == 1
                          else torch.cat([p.to(self.device)
                                          for p in self._parts]))
            self._parts = [self._rows]
        return self._rows

    def _versions(self, at, nq: int) -> torch.Tensor:
        if at is None:
            at = self.version
        return torch.as_tensor(at, dtype=torch.int64,
                               device=self.device).expand(nq)

    def distances(self, queries, ids) -> torch.Tensor:
        """``[Q, k]`` float64 squared distance of each listed id's row from
        its query, in the direct form ``sum((x - q)^2)``, whether the id is
        live or not; +inf where an id was never given out or repeats an
        earlier id of its query."""
        rows = self.rows()
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        ok = (ids >= 0) & (ids < self.size)
        x = rows[ids.clamp(0, max(self.size - 1, 0)).reshape(-1)]
        x = x.to(torch.float64).view(*ids.shape, -1)
        q = torch.as_tensor(queries, device=self.device).to(torch.float64)
        d = torch.sum((x - q[:, None, :]) ** 2, dim=-1)
        dup = torch.zeros_like(ok)
        for j in range(1, ids.shape[1]):
            dup[:, j] = (ids[:, :j] == ids[:, j:j + 1]).any(dim=1)
        return torch.where(ok & ~dup, d, _INF)

    def knn(self, queries, k: int, at=None, *, chunk: int | None = None,
            extra: int = 16):
        """The exact ``k`` nearest rows live at version ``at`` (one
        version, or ``[Q]`` versions, one a query; default now):
        ``(ids [Q, k] int64, dist [Q, k] float64)``, nearest first, lower
        id first on equal distances, -1 / +inf past the live rows. Blocks
        of rows are screened in the product form ``|q|^2 - 2 q.x + |x|^2``
        (float64) for their ``k + extra`` best live rows, and the
        survivors ranked in the direct form."""
        q = torch.as_tensor(queries, device=self.device).to(torch.float64)
        nq, n = q.shape[0], self.size
        if n == 0:
            return (torch.full((nq, k), -1, device=q.device),
                    torch.full((nq, k), _INF, dtype=torch.float64,
                               device=q.device))
        rows = self.rows()
        v = self._versions(at, nq)[:, None]
        qq = torch.sum(q * q, dim=1, keepdim=True)
        if chunk is None:  # a [Q, chunk] float64 screen of ~2 GB at most
            chunk = max(1024, (1 << 28) // max(1, nq))
        keep = min(k + extra, n)
        best_d = torch.full((nq, 0), _INF, dtype=torch.float64,
                            device=self.device)
        best_i = torch.zeros((nq, 0), dtype=torch.int64, device=self.device)
        with full_precision():
            for lo in range(0, n, chunk):
                x = rows[lo:lo + chunk].to(torch.float64)
                d = qq - 2.0 * (q @ x.T) + torch.sum(x * x, dim=1)[None]
                alive = ((self._born[lo:lo + chunk][None] <= v)
                         & (v < self._died[lo:lo + chunk][None]))
                d = torch.where(alive, d, _INF)
                dv, di = torch.topk(d, min(keep, d.shape[1]), dim=1,
                                    largest=False)
                dv = torch.cat([best_d, dv], 1)
                di = torch.cat([best_i, di + lo], 1)
                best_d, pos = torch.topk(dv, min(keep, dv.shape[1]), dim=1,
                                         largest=False)
                best_i = di.gather(1, pos)
                del d, x, alive
        # rank the survivors exactly: direct form, then id on ties; a
        # survivor that is not live (fewer live rows than kept) is padding
        exact = torch.where(torch.isinf(best_d), _INF,
                            self.distances(q, best_i))
        by_id = torch.sort(best_i, dim=1, stable=True)
        exact = exact.gather(1, by_id.indices)
        dist, pos = torch.sort(exact, dim=1, stable=True)
        ids = by_id.values.gather(1, pos)
        ids = torch.where(torch.isinf(dist), -1, ids)
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            dist = torch.nn.functional.pad(dist, (0, pad), value=_INF)
        return ids[:, :k], dist[:, :k]
