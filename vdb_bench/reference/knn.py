"""Exact k-nearest neighbours in float64, and the low-precision controls.

Distances are squared Euclidean; under ``metric="cosine"`` both sides are
first scaled to unit length (cosine distance is then half of it), as the
program's ``pack_database(metric="cosine")`` defines its answers. The
reference works in float64 throughout, in blocks of rows, so that it fits
beside nothing on the card once the program's state is freed.
"""

from __future__ import annotations

import contextlib

import torch

_INF = float("inf")


@contextlib.contextmanager
def full_precision():
    """float32 matrix products without TF32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def metric_rows(x: torch.Tensor, metric: str, dtype=torch.float64):
    """``x`` in ``dtype``, scaled to unit rows under ``cosine``."""
    x = x.to(dtype)
    if metric == "cosine":
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
            1e-300 if dtype == torch.float64 else 1e-30)
    elif metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    return x


def distances(rows, queries, ids, metric: str) -> torch.Tensor:
    """``[Q, k]`` float64 distance of each listed row id from its query,
    in the direct form ``sum((x - q)^2)``; +inf where an id is not a row
    or repeats an earlier id of its query."""
    n = rows.shape[0]
    ids = ids.to(device=rows.device, dtype=torch.int64)
    ok = (ids >= 0) & (ids < n)
    x = metric_rows(rows[ids.clamp(0, n - 1).reshape(-1)], metric)
    x = x.view(*ids.shape, -1)
    q = metric_rows(queries.to(rows.device), metric)[:, None, :]
    d = torch.sum((x - q) ** 2, dim=-1)
    # an id is a repeat when an earlier id of its query equals it
    dup = torch.zeros_like(ok)
    for j in range(1, ids.shape[1]):
        dup[:, j] = (ids[:, :j] == ids[:, j:j + 1]).any(dim=1)
    return torch.where(ok & ~dup, d, _INF)


def exact_knn(rows, queries, k: int, metric: str, *, chunk: int = 1 << 17,
              extra: int = 16):
    """The exact ``k`` nearest rows of each query: ``(ids [Q, k] int64,
    dist [Q, k] float64)``, nearest first, lower id first on equal
    distances. Row blocks are screened in the product form
    ``|q|^2 - 2 q.x + |x|^2`` (float64) for their ``k + extra`` best, and
    the survivors ranked in the direct form."""
    q = metric_rows(queries.to(rows.device), metric)
    qq = torch.sum(q * q, dim=1)
    n = rows.shape[0]
    keep = min(k + extra, n)
    best_d = best_i = None
    for lo in range(0, n, chunk):
        x = metric_rows(rows[lo:lo + chunk], metric)
        d = qq[:, None] - 2.0 * (q @ x.T) + torch.sum(x * x, dim=1)[None]
        dv, di = torch.topk(d, min(keep, d.shape[1]), dim=1, largest=False)
        di += lo
        if best_d is not None:
            dv, di = torch.cat([best_d, dv], 1), torch.cat([best_i, di], 1)
            dv, pos = torch.topk(dv, min(keep, dv.shape[1]), dim=1,
                                 largest=False)
            di = di.gather(1, pos)
        best_d, best_i = dv, di
        del d, x
    # rank the survivors exactly: direct form, then id on ties
    exact = distances(rows, queries, best_i, metric)
    by_id = torch.sort(best_i, dim=1, stable=True)
    exact = exact.gather(1, by_id.indices)
    dist, pos = torch.sort(exact, dim=1, stable=True)
    return by_id.values.gather(1, pos)[:, :k], dist[:, :k]


class LowReference:
    """A control: the reference computed in a precision below the
    configuration's bfloat16 scan, put in the program's place.

    ``fmt="int8"``: rows and queries rounded to int8 with one symmetric
    scale ``sq = 127 / max|x|`` over the (unit, under cosine) rows, as the
    program's own int8 packs are. ``fmt="fp8"``: rows and each query
    batch cast to float8 e4m3 after a scale of their own
    (``448 / max|x|``), the card's fp8 tensor-core recipe. Either way the
    products accumulate in float32 (TF32 off: exact for int8), the ``k``
    best by that score come back, and so do their distances,
    ``|x|^2 - 2 x.q + |q|^2`` of the low-precision values over the
    scales. ``query`` has the served system's shape: host queries in,
    ``(ids, dist)`` on the host."""

    def __init__(self, rows, metric: str, k: int, fmt: str = "fp8", *,
                 chunk: int = 1 << 16):
        if fmt not in ("int8", "fp8"):
            raise ValueError(f"unknown control precision {fmt!r}")
        self.metric, self.k, self.fmt, self.chunk = metric, k, fmt, chunk
        x = metric_rows(rows, metric, torch.float32)
        self.sx = (127.0 if fmt == "int8" else 448.0) / float(x.abs().max())
        self.xl = self._low(x, self.sx)
        self.xx = torch.sum(self.xl * self.xl, dim=1)

    def _low(self, x, scale):
        """``x * scale`` in the control's precision, as float32 values."""
        if self.fmt == "int8":
            return torch.round(x * scale).clamp_(-127, 127)
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32)

    def query(self, queries):
        dev = self.xl.device
        q = metric_rows(torch.as_tensor(queries, device=dev), self.metric,
                        torch.float32)
        sq = self.sx if self.fmt == "int8" else 448.0 / float(q.abs().max())
        ql = self._low(q, sq)
        q2 = torch.sum(ql * ql, dim=1) * (self.sx / sq) ** 2
        best_d = best_i = None
        with full_precision():
            for lo in range(0, self.xl.shape[0], self.chunk):
                x = self.xl[lo:lo + self.chunk]
                # in units of the rows' scale squared
                s = q2[:, None] - 2.0 * (self.sx / sq) * (ql @ x.T) + \
                    self.xx[lo:lo + self.chunk][None]
                dv, di = torch.topk(s, min(self.k, s.shape[1]), dim=1,
                                    largest=False)
                di += lo
                if best_d is not None:
                    dv = torch.cat([best_d, dv], 1)
                    di = torch.cat([best_i, di], 1)
                    dv, pos = torch.topk(dv, self.k, dim=1, largest=False)
                    di = di.gather(1, pos)
                best_d, best_i = dv, di
        dist = best_d / (self.sx * self.sx)
        return best_i.to(torch.int32).cpu(), dist.float().cpu()
