"""The delta merge's k-NN kernel: wrapper, plain version, launch count.

``delta_knn`` gives the ``k`` nearest live rows of ``DynamicIndex``'s
delta to each query: exact f32 difference-form distances and a tie-exact
top-k. No Pallas kernel does this: the JAX package merges on the host.
On a CUDA tensor the wrapper launches ``csrc/delta_knn.cu`` (built with
``nvcc`` at first use; its header says what bounds it on an H100) and
``COUNTERS`` counts its launches (``dynamic.delta_knn.launches``); on a
CPU tensor it runs ``delta_knn_reference``, the plain torch version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vector_database_tpu_torch.ops import cuda_build
from vector_database_tpu_torch.ops.exact import exact_d2_blocked
from vector_database_tpu_torch.ops.scan_knn import _lowest_k
from vector_database_tpu_torch.utils.profiling import COUNTERS


def delta_knn_reference(queries, delta, live, k: int):
    """Plain version of ``delta_knn``: ``exact_d2_blocked`` over every
    slot, +inf where ``live`` is False, then ``scan_knn._lowest_k``. Its
    places past the live rows hold +inf with the lowest dead slots."""
    mask = torch.as_tensor(live, device=delta.device)
    d2 = torch.where(mask, exact_d2_blocked(queries, delta), float("inf"))
    return _lowest_k(d2, min(k, delta.shape[0]))


def _declare(lib):
    lib.delta_knn_scratch.argtypes = [ctypes.c_int] * 3
    lib.delta_knn_scratch.restype = ctypes.c_longlong
    lib.delta_knn_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_void_p])
    lib.delta_knn_launch.restype = ctypes.c_int


def _load():
    return cuda_build.load("delta_knn", _declare)


def delta_knn(queries: torch.Tensor, delta: torch.Tensor, live, k: int):
    """The ``k`` nearest live rows of ``delta`` to each query: ``(d2
    [Q, kk], slots [Q, kk])``, kk = min(k, R), f32 squared distances and
    int64 rows of ``delta``, ascending by (distance, slot): equal
    distances keep the lower slot, also on a tie at the k-th place.

    ``queries`` [Q, D] and ``delta`` [R, D] are float32 on one device;
    ``live`` is an [R] bool mask on the host, or the live slots as an
    ascending int32 tensor on the delta's device. Each distance is the
    f32 difference form, a subtraction and a square added a dimension,
    in ascending order. On a CUDA device places past the live rows hold
    (+inf, -1), and the kernel launches twice a pass of up to 128 places
    (the pass over the split rows, then the join of the splits)."""
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
    if k < 1:
        raise ValueError(f"delta_knn: k must be >= 1, got {k}")
    dev, (nq, d), rows = delta.device, queries.shape, delta.shape[0]
    if isinstance(live, torch.Tensor):
        if live.dtype != torch.int32 or live.dim() != 1 or live.device != dev:
            raise ValueError(f"delta_knn: live slots must be int32 [n] on "
                             f"{dev}, got {live.dtype} {tuple(live.shape)}")
        slots = live
    else:
        live = np.asarray(live)
        if live.dtype != np.bool_ or live.shape != (rows,):
            raise ValueError(f"delta_knn: live must be a ({rows},) bool "
                             f"mask, got {live.dtype} {live.shape}")
        slots = torch.from_numpy(np.flatnonzero(live).astype(np.int32))
        slots = slots.to(dev)
    kk = min(k, rows)
    if dev.type != "cuda":
        mask = torch.zeros(rows, dtype=torch.bool, device=dev)
        return delta_knn_reference(queries, delta,
                                   mask.index_fill_(0, slots.long(), True),
                                   kk)
    out_d = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    out_s = torch.empty((nq, kk), dtype=torch.int64, device=dev)
    if nq == 0:
        return out_d, out_s
    if d == 0:  # every distance 0, as over one zero column
        queries, delta = queries.new_zeros((nq, 1)), delta.new_zeros((rows, 1))
    queries, delta = queries.contiguous(), delta.contiguous()
    lib = _load()
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
