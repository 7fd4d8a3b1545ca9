"""ctypes bindings for the native (C++) vector store and the chunked
host-to-device ingest (port of
``vector_database_tpu/runtime/native_store.py``).

The shared library is compiled from this package's copy of ``vstore.cpp``
with ``g++`` at first use, into ``build/vector_database_tpu_torch/`` (listed
in ``.gitignore``), under a name that carries a hash of the source and the
flags: an edit rebuilds, an unchanged source builds once. The compiler
writes a temporary file that is then renamed into place, so processes that
build at once (test workers) each load a whole library.

``NativeVectorStore`` is the out-of-core ingest path: vectors live in a
memory-mapped file on the host; ``to_device`` assembles them on the device
in chunks, staging each through pinned host memory so that the host copy
of the next chunk overlaps the transfer of the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from vector_database_tpu_torch.utils.device import resolve_device

_SRC = Path(__file__).resolve().with_name("vstore.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "vector_database_tpu_torch"
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the store's library is (or will be) built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return _BUILD_DIR / f"libvstore_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
        # atomic: a concurrent process never loads a partly written file
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        u64, p = ctypes.c_uint64, ctypes.c_void_p
        fp = ctypes.POINTER(ctypes.c_float)
        lib.vs_create.restype = p
        lib.vs_create.argtypes = [ctypes.c_char_p, u64, u64]
        lib.vs_open.restype = p
        lib.vs_open.argtypes = [ctypes.c_char_p]
        lib.vs_error.restype = ctypes.c_char_p
        lib.vs_error.argtypes = [p]
        for name in ("vs_count", "vs_dims", "vs_capacity"):
            getattr(lib, name).restype = u64
            getattr(lib, name).argtypes = [p]
        lib.vs_append.restype = ctypes.c_int
        lib.vs_append.argtypes = [p, fp, u64]
        lib.vs_rows.restype = fp
        lib.vs_rows.argtypes = [p, u64]
        lib.vs_read.restype = ctypes.c_int
        lib.vs_read.argtypes = [p, u64, u64, fp]
        lib.vs_flush.restype = ctypes.c_int
        lib.vs_flush.argtypes = [p]
        lib.vs_close.restype = None
        lib.vs_close.argtypes = [p]
        lib.vs_import_fvecs.restype = ctypes.c_int64
        lib.vs_import_fvecs.argtypes = [p, ctypes.c_char_p]
        _lib = lib
        return lib


class NativeVectorStore:
    """Memory-mapped float32 row store backed by the C++ runtime."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        err = lib.vs_error(handle)
        if err:
            msg = err.decode()
            self._h = None
            lib.vs_close(handle)  # free the Store struct + any open fd
            raise OSError(msg)

    # --- constructors ------------------------------------------------------
    @classmethod
    def create(cls, path: str, dims: int, capacity_rows: int = 1024):
        lib = load_library()
        return cls(lib.vs_create(str(path).encode(), dims, capacity_rows),
                   lib)

    @classmethod
    def open(cls, path: str):
        lib = load_library()
        return cls(lib.vs_open(str(path).encode()), lib)

    def _handle(self):
        """Live native handle, or a Python exception: every C entry point
        dereferences the struct pointer, so a closed or failed store must
        never reach the FFI (it would SIGSEGV the process)."""
        if self._h is None:
            raise ValueError("store is closed")
        return self._h

    # --- core API ----------------------------------------------------------
    def __len__(self) -> int:
        return int(self._lib.vs_count(self._handle()))

    @property
    def dims(self) -> int:
        return int(self._lib.vs_dims(self._handle()))

    def append(self, rows) -> None:
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.dims:
            raise ValueError("invalid vector size")
        ptr = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.vs_append(self._handle(), ptr, rows.shape[0]) != 0:
            raise OSError(self._lib.vs_error(self._h).decode())

    def rows(self, start: int, nrows: int) -> np.ndarray:
        """Zero-copy view of stored rows (valid until the next append)."""
        if start < 0 or start + nrows > len(self):
            raise IndexError("row range out of bounds")
        ptr = self._lib.vs_rows(self._handle(), start)
        return np.ctypeslib.as_array(ptr, shape=(nrows, self.dims))

    def read(self, start: int, nrows: int) -> np.ndarray:
        """Copying read."""
        out = np.empty((nrows, self.dims), dtype=np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.vs_read(self._handle(), start, nrows, ptr) != 0:
            raise IndexError("row range out of bounds")
        return out

    def flush(self) -> None:
        self._lib.vs_flush(self._handle())

    def close(self) -> None:
        if self._h:
            self._lib.vs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- ingest ------------------------------------------------------------
    def import_fvecs(self, path: str) -> int:
        """Bulk-import an fvecs file (SIFT / ann-benchmarks format)."""
        n = self._lib.vs_import_fvecs(self._handle(), str(path).encode())
        if n < 0:
            raise OSError(self._lib.vs_error(self._h).decode())
        return int(n)

    def chunks(self, chunk_rows: int = 100_000) -> Iterator[np.ndarray]:
        """Zero-copy chunk iterator (the reference's 100k-row feed)."""
        n = len(self)
        for start in range(0, n, chunk_rows):
            yield self.rows(start, min(chunk_rows, n - start))

    def to_device(self, chunk_rows: int = 500_000, sharding=None, *,
                  device=None) -> torch.Tensor:
        """The whole store as one ``[N, D]`` f32 tensor on ``device``
        (default: the card), assembled chunk by chunk (see
        :func:`stream_rows_to_device`)."""
        return stream_rows_to_device(
            self.rows, len(self), self.dims, chunk_rows=chunk_rows,
            sharding=sharding, device=device,
        )


def stream_rows_to_device(row_source, n, d, *, chunk_rows: int = 500_000,
                          sharding=None, device=None) -> torch.Tensor:
    """Assemble an ``[n, d]`` f32 tensor on ``device`` (default: the card)
    from host chunks, with peak device memory ``n`` rows (no concatenate).

    ``row_source(start, rows)`` returns that host slice (a store's ``rows``
    method, a numpy array's slicer, ...). On the card each chunk is copied
    into one of two pinned host buffers and sent from there with
    ``non_blocking=True`` on a side stream straight into its rows of the
    preallocated result, so the host copy of chunk ``i+1`` overlaps the
    transfer of chunk ``i``; a buffer is refilled only after its last
    transfer's event. The caller's stream waits for the side stream before
    the result is returned. ``sharding`` (JAX's placement of the result
    across a mesh) raises: on a ``torch.distributed`` mesh each rank reads
    its own rows with ``parallel.make_sharded_rows(store, mesh)``."""
    if sharding is not None:
        raise NotImplementedError(
            "stream_rows_to_device: sharding= has no counterpart; on a mesh "
            "each rank reads its own rows with "
            "vector_database_tpu_torch.parallel.make_sharded_rows(store, "
            "mesh)")
    device = resolve_device(device)
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    spans = [(s, min(chunk_rows, n - s)) for s in range(0, n, chunk_rows)]
    if device.type != "cuda":
        for start, rows in spans:
            out[start:start + rows] = torch.from_numpy(
                np.array(row_source(start, rows), np.float32))
        return out
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)  # `out` was allocated on the main stream
    width = min(chunk_rows, n)
    bufs = [torch.empty((width, d), dtype=torch.float32, pin_memory=True)
            for _ in range(min(2, len(spans)))]
    done = [None] * len(bufs)
    with torch.cuda.stream(side):
        for i, (start, rows) in enumerate(spans):
            slot = i % len(bufs)
            if done[slot] is not None:
                done[slot].synchronize()  # its last transfer has landed
            host = bufs[slot][:rows]
            host.numpy()[...] = row_source(start, rows)
            out[start:start + rows].copy_(host, non_blocking=True)
            done[slot] = torch.cuda.Event()
            done[slot].record(side)
    main.wait_stream(side)
    out.record_stream(side)
    return out
