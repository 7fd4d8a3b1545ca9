"""Exact brute-force search: the recall oracle and the QPS floor.

Port of ``vector_database_tpu/ops/exact.py``. Every function keeps the
form of its JAX counterpart: ``pairwise_sq_dists`` and ``exact_knn`` the
matmul expansion, ``exact_sq_dists`` the difference form, and
``exact_d2_blocked`` (``vector_database_tpu/dynamic.py``'s
``_exact_d2_blocked``, the mutable collections' exact fallback) the
difference form in row blocks. Products are full f32: PyTorch may run
an f32 matmul on the card in TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` is set, so the oracle turns it
off explicitly for its own products (``full_f32``) and restores the
caller's setting afterwards.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vector_database_tpu_torch.utils.device import resolve_device


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested list) as a float32 tensor on
    ``resolve_device(device, x)``: ``device`` if given, else where a
    tensor ``x`` lies, else the card (``cuda``) for host data."""
    device = resolve_device(device, x)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    arr = np.asarray(x, np.float32)
    if not arr.flags.writeable:  # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.as_tensor(arr, device=device)


def atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() >= 2 else x.reshape(1, -1)


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (one copy to the host) or an array-like as
    a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def full_f32():
    """Run f32 matmuls at full f32 precision (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def smallest_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` smallest entries of each row,
    ascending, equal values in index order (as ``lax.top_k`` of ``-x``
    orders them, except for ties that straddle the k-th place)."""
    vals, idx = torch.topk(x, k, dim=1, largest=False, sorted=False)
    o = torch.argsort(idx, dim=1)
    vals, idx = vals.gather(1, o), idx.gather(1, o)
    o = torch.argsort(vals, dim=1, stable=True)
    return vals.gather(1, o), idx.gather(1, o)


def pairwise_sq_dists(queries: torch.Tensor, vectors: torch.Tensor):
    """Squared L2 distances ``[Q, N]`` via the matmul expansion
    ``|q|^2 + |v|^2 - 2 q.v``, clamped at 0, in full f32."""
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    vn = torch.sum(vectors * vectors, dim=1)
    with full_f32():
        cross = queries @ vectors.T
    return torch.clamp(qn + vn[None, :] - 2.0 * cross, min=0.0)


def exact_sq_dists(queries: torch.Tensor, vectors: torch.Tensor):
    """Squared L2 distances ``[Q, N]`` via direct subtraction: the same
    operation shape as the tree search's rerank, so oracle and index agree
    on boundary points. O(Q*N*D) memory: tests only."""
    diff = queries[:, None, :] - vectors[None, :, :]
    return torch.sum(diff * diff, dim=-1)


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


def exact_ball(vectors, queries, radius, *, use_matmul: bool = False):
    """Boolean match matrix ``[Q, N]``: within inclusive L2 ``radius``."""
    vectors = as_f32(vectors)
    queries = atleast_2d(as_f32(queries, vectors.device))
    d2 = (pairwise_sq_dists if use_matmul else exact_sq_dists)(
        queries, vectors
    )
    r = torch.tensor(radius, dtype=torch.float32)
    return d2 <= r * r


def exact_knn(vectors, queries, *, k: int, block: int | None = None):
    """Exact k nearest neighbors: ``(indices [Q, k], sq_dists [Q, k])``.

    Above ``block`` rows the distance matrix is streamed in ``[Q, block]``
    tiles with a running top-k merge, so the full ``[Q, N]`` matrix never
    materializes. ``block=None`` caps the f32 tile at ~2 GiB. ``k > n``
    pads with -1 / +inf."""
    vectors = as_f32(vectors)
    queries = atleast_2d(as_f32(queries, vectors.device))
    if block is None:
        q_rows = queries.shape[0] or 1
        block = max(65_536, min(1_000_000, (1 << 29) // q_rows))
    n = vectors.shape[0]
    q = queries.shape[0]
    kk = min(k, n)
    cd = torch.full((q, 0), float("inf"), device=vectors.device)
    ci = torch.full((q, 0), -1, dtype=torch.int64, device=vectors.device)
    for base in range(0, n, block):
        d2 = pairwise_sq_dists(queries, vectors[base : base + block])
        bd, bi = smallest_k(d2, min(kk, d2.shape[1]))
        cat_d = torch.cat([cd, bd], dim=1)
        cat_i = torch.cat([ci, bi + base], dim=1)
        # stable: on equal distances the earlier (lower) row stays first
        o = torch.argsort(cat_d, dim=1, stable=True)[:, :kk]
        cd, ci = cat_d.gather(1, o), cat_i.gather(1, o)
    if kk < k:
        ci = torch.nn.functional.pad(ci, (0, k - kk), value=-1)
        cd = torch.nn.functional.pad(cd, (0, k - kk), value=float("inf"))
    return ci, cd


def exact_mips(vectors, queries, *, k: int):
    """Exact maximum-inner-product search: ``(indices [Q, k], dots [Q,
    k])``, highest dot first; ``k > n`` pads with -1 / -inf."""
    vectors = as_f32(vectors)
    queries = atleast_2d(as_f32(queries, vectors.device))
    with full_f32():
        dots = queries @ vectors.T
    kk = min(k, dots.shape[1])
    best, idx = torch.sort(dots, dim=1, descending=True, stable=True)
    best, idx = best[:, :kk], idx[:, :kk]
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
        best = torch.nn.functional.pad(best, (0, k - kk),
                                       value=float("-inf"))
    return idx, best


def normalize_rows(vectors) -> torch.Tensor:
    """Unit-normalize rows (zero rows stay zero): cosine reduces to L2
    over normalized vectors, ``cos = 1 - d2/2``."""
    vectors = as_f32(vectors)
    norm = torch.sqrt(torch.sum(vectors * vectors, dim=1, keepdim=True))
    return vectors / torch.clamp(norm, min=1e-30)
