"""Synthetic datasets and ingest helpers.

The fixtures mirror the reference's test and benchmark inputs:

- uniform random ``[-1, 1]`` vectors (VectorIndex.MainTest/Program.cs:163-181);
- the crafted one-hot adversarial set — every dimension has identical
  statistics, stressing the tie-breaking paths (Program.cs:34-67);
- normalized k×k grids (MemoryVectorIndexTests.cs:11-92) and the
  deliberately non-normalized grid (MemoryVectorIndexTests.cs:95-113);
- chunked HDF5 ingest for ann-benchmarks files such as
  deep-image-96-angular (Program.cs:183-260).
"""

from __future__ import annotations

import numpy as np


def random_uniform(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Uniform random vectors in [-1, 1]^d (Program.cs:163-181)."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, d), dtype=np.float32) * 2.0 - 1.0).astype(
        np.float32
    )


def one_hot_crafted(d: int = 1536) -> np.ndarray:
    """d one-hot vectors of dimension d — the adversarial set where every
    dimension has identical mean/stdev (Program.cs:34-67)."""
    return np.eye(d, dtype=np.float32)


def grid2d(k: int) -> np.ndarray:
    """Normalized k×k 2-D grid in [-1, 1]^2 (MemoryVectorIndexTests.cs)."""
    half = (k - 1) / 2.0
    scale = k / 2.0
    axis = (np.arange(k, dtype=np.float32) - half) / scale
    return np.stack(
        np.meshgrid(axis, axis, indexing="ij"), axis=-1
    ).reshape(-1, 2)


def grid2d_not_normalized(k: int) -> np.ndarray:
    """k×k grid with raw integer coordinates offset by -1 — the degraded
    non-normalized fixture (MemoryVectorIndexTests.cs:95-113)."""
    axis = np.arange(k, dtype=np.float32) - 1.0
    return np.stack(
        np.meshgrid(axis, axis, indexing="ij"), axis=-1
    ).reshape(-1, 2)


def load_hdf5(path: str, dataset: str = "/train", chunk: int = 100_000):
    """Yield ``(start_row, chunk_array)`` blocks from an ann-benchmarks HDF5
    file, mirroring the reference's 100k-row chunked reader
    (Program.cs:221-260). Requires ``h5py``."""
    import h5py

    with h5py.File(path, "r") as f:
        ds = f[dataset.lstrip("/")]
        n = ds.shape[0]
        for start in range(0, n, chunk):
            yield start, np.asarray(
                ds[start : min(start + chunk, n)], dtype=np.float32
            )


def hdf5_size(path: str, dataset: str = "/train"):
    """Return ``(rows, dims)`` of an HDF5 dataset (Program.cs:183-219)."""
    import h5py

    with h5py.File(path, "r") as f:
        ds = f[dataset.lstrip("/")]
        if ds.ndim != 2:
            raise ValueError("invalid rank")
        return int(ds.shape[0]), int(ds.shape[1])


def load_vectors_csv(path: str):
    """Read the reference harness's dataset CSV export: one header line,
    then ``{id}|{v1,v2,...}`` rows (Program.cs:95-99 for /train — the
    /test writer at :118-122 declares a ``ID,Vector`` header but writes
    the same ``|`` rows, so both files parse here). Returns
    ``(ids, vectors)`` as ``int64[n]`` / ``float32[n, d]`` numpy arrays;
    together with ``BSPIndex.from_reference_csv`` this migrates a full
    reference deployment (data + built index) without a rebuild.

    Only the first non-blank line may be a header; any later malformed
    row (missing ``|``, non-integer id, unparseable float element)
    raises with its line number — corruption is never silently dropped,
    which would shift the id/row alignment the index import relies on.
    """
    ids, rows = [], []
    may_be_header = True
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue  # blank
            sid, _, svec = line.partition("|")
            if not (_ and sid.strip().lstrip("-").isdigit()):
                if may_be_header:
                    may_be_header = False
                    continue  # the single allowed header line
                raise ValueError(f"{path}:{lineno}: malformed row {line!r}")
            may_be_header = False
            try:
                vec = np.array([float(t) for t in svec.split(",")],
                               dtype=np.float32)
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: unparseable vector element in "
                    f"{svec!r}"
                ) from None
            ids.append(int(sid))
            rows.append(vec)
    if not rows:
        raise ValueError(f"no vector rows in {path}")
    vecs = np.stack(rows)
    return np.asarray(ids, np.int64), vecs
