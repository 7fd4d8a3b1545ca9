"""NativeVectorStore of vector_database_tpu_torch against the JAX package's.

The tests of ``tests/test_native_store.py`` on the port's store (its own
copy of ``vstore.cpp``, built into ``build/``), plus the file format shared
with the JAX store (each opens what the other wrote), ``to_device`` on the
CPU, and two processes building the library at once.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vector_database_tpu.runtime.native_store import (
    NativeVectorStore as JaxNativeVectorStore,
)
from vector_database_tpu_torch import NativeVectorStore
from vector_database_tpu_torch.runtime import native_store
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_create_append_read(tmp_path):
    path = str(tmp_path / "v.store")
    with NativeVectorStore.create(path, dims=8) as store:
        data = datasets.random_uniform(100, 8, seed=70)
        store.append(data)
        assert len(store) == 100
        np.testing.assert_array_equal(store.read(0, 100), data)
        np.testing.assert_array_equal(store.rows(10, 5), data[10:15])


def test_growth_beyond_capacity(tmp_path):
    path = str(tmp_path / "v.store")
    with NativeVectorStore.create(path, dims=4, capacity_rows=8) as store:
        for i in range(40):  # several remaps
            store.append(np.full((7, 4), float(i), np.float32))
        assert len(store) == 280
        np.testing.assert_array_equal(
            store.read(273, 7), np.full((7, 4), 39.0, np.float32))


def test_persistence(tmp_path):
    path = str(tmp_path / "v.store")
    data = datasets.random_uniform(50, 6, seed=71)
    with NativeVectorStore.create(path, dims=6) as store:
        store.append(data)
        store.flush()
    with NativeVectorStore.open(path) as store:
        assert len(store) == 50 and store.dims == 6
        np.testing.assert_array_equal(store.read(0, 50), data)


@pytest.mark.parametrize("writer,reader", [
    (JaxNativeVectorStore, NativeVectorStore),
    (NativeVectorStore, JaxNativeVectorStore),
])
def test_store_file_shared_with_jax(tmp_path, writer, reader):
    path = str(tmp_path / "v.store")
    data = datasets.random_uniform(300, 5, seed=74)
    with writer.create(path, dims=5, capacity_rows=16) as store:
        store.append(data)
        store.flush()
    with reader.open(path) as store:
        assert len(store) == 300 and store.dims == 5
        np.testing.assert_array_equal(store.read(0, 300), data)


def test_append_dim_mismatch(tmp_path):
    with NativeVectorStore.create(str(tmp_path / "v"), dims=4) as store:
        with pytest.raises(ValueError):
            store.append(np.zeros((2, 5), np.float32))


def test_append_tensor(tmp_path):
    data = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=4) as store:
        store.append(data)
        np.testing.assert_array_equal(store.read(0, 3), data.numpy())


def test_read_out_of_bounds(tmp_path):
    with NativeVectorStore.create(str(tmp_path / "v"), dims=4) as store:
        store.append(np.zeros((3, 4), np.float32))
        with pytest.raises(IndexError):
            store.read(2, 5)
        with pytest.raises(IndexError):
            store.rows(4, 1)


def _write_fvecs(path, data):
    with open(path, "wb") as f:
        for row in data:
            f.write(struct.pack("<i", row.shape[0]))
            f.write(row.astype("<f4").tobytes())


def test_import_fvecs(tmp_path):
    data = datasets.random_uniform(20, 5, seed=72)
    fpath = str(tmp_path / "base.fvecs")
    _write_fvecs(fpath, data)
    with NativeVectorStore.create(str(tmp_path / "v"), dims=5) as store:
        assert store.import_fvecs(fpath) == 20
        np.testing.assert_array_equal(store.read(0, 20), data)


def test_import_fvecs_dim_mismatch(tmp_path):
    fpath = str(tmp_path / "bad.fvecs")
    _write_fvecs(fpath, np.zeros((1, 3), np.float32))
    with NativeVectorStore.create(str(tmp_path / "v"), dims=5) as store:
        with pytest.raises(OSError):
            store.import_fvecs(fpath)


def test_chunked_device_ingest_feeds_build(tmp_path):
    """``to_device`` (here on the CPU) gives the store's rows; the port's
    build over them answers radius queries as the JAX package's build
    over the same rows does."""
    from vector_database_tpu import build_index_fused as jax_build
    from vector_database_tpu import search as jax_search
    from vector_database_tpu_torch import build_index_fused, exact_ball, search

    data = datasets.random_uniform(1200, 8, seed=73)
    with NativeVectorStore.create(str(tmp_path / "v.store"), dims=8) as store:
        store.append(data)
        matrix = store.to_device(chunk_rows=500, device="cpu")
        assert matrix.shape == (1200, 8) and matrix.device.type == "cpu"
        np.testing.assert_array_equal(matrix.numpy(), data)
        index = build_index_fused(matrix, leaf_size=4)
    queries = data[:4]
    res = search(index, queries, 0.5)
    jres = jax_search(jax_build(data, leaf_size=4), queries, 0.5)
    truth = exact_ball(torch.from_numpy(data), queries, 0.5)
    for qi in range(4):
        want = set(torch.nonzero(truth[qi])[:, 0].tolist())
        assert set(res.match_rows(qi).tolist()) == want
        assert set(jres.match_rows(qi).tolist()) == want


def test_to_device_sharding_raises(tmp_path):
    with NativeVectorStore.create(str(tmp_path / "v"), dims=4) as store:
        store.append(np.zeros((3, 4), np.float32))
        with pytest.raises(NotImplementedError, match="sharding"):
            store.to_device(sharding=object(), device="cpu")


def test_open_corrupt_store_errors_not_crashes(tmp_path):
    """A truncated or corrupted store raises OSError from open(), not
    SIGBUS later on read, and failed opens do not leak the handle."""
    path = str(tmp_path / "s.vstore")
    st = NativeVectorStore.create(path, dims=4, capacity_rows=8)
    st.append(np.ones((6, 4), np.float32))
    st.close()
    with open(path, "r+b") as f:
        f.truncate(64 + 3 * 4 * 4)  # header + 3 rows of the 6 it claims
    with pytest.raises(OSError):
        NativeVectorStore.open(path)
    with open(path, "r+b") as f:
        f.truncate(64)  # header only
    with pytest.raises(OSError):
        NativeVectorStore.open(path)
    before = len(os.listdir("/proc/self/fd"))
    for _ in range(32):
        with pytest.raises(OSError):
            NativeVectorStore.open(path)
    assert len(os.listdir("/proc/self/fd")) <= before + 1


def test_use_after_close_raises(tmp_path):
    """A closed store raises a Python exception and never reaches the FFI
    (a NULL struct pointer would SIGSEGV the process)."""
    path = str(tmp_path / "uac.vstore")
    st = NativeVectorStore.create(path, dims=4)
    st.append(np.ones((2, 4), np.float32))
    st.close()
    for call in (
        lambda: len(st),
        lambda: st.dims,
        lambda: st.append(np.ones((1, 4), np.float32)),
        lambda: st.rows(0, 1),
        lambda: st.read(0, 1),
        lambda: st.flush(),
        lambda: st.import_fvecs(path),
        lambda: st.to_device(device="cpu"),
    ):
        with pytest.raises(ValueError, match="closed"):
            call()
    st.close()  # idempotent


def test_import_fvecs_rolls_back_on_error(tmp_path):
    """A mid-file import error rewinds the row count: a retried import
    would otherwise duplicate the first half of the file."""
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    good = tmp_path / "good.fvecs"
    _write_fvecs(good, rows)
    bad = tmp_path / "bad.fvecs"
    bad.write_bytes(good.read_bytes()[:-8])  # truncate the final row
    st = NativeVectorStore.create(str(tmp_path / "rb.vstore"), dims=4)
    st.append(np.full((2, 4), 7.0, np.float32))
    with pytest.raises(OSError, match="truncated"):
        st.import_fvecs(str(bad))
    assert len(st) == 2
    assert st.import_fvecs(str(good)) == 3
    assert len(st) == 5
    np.testing.assert_array_equal(st.read(2, 3), rows)
    st.close()


def test_library_built_outside_the_source_tree():
    path = native_store.library_path()
    native_store.load_library()
    assert path.exists()
    assert path.parent.parts[-2:] == ("build", "vector_database_tpu_torch")
    assert not list(Path(native_store.__file__).parent.glob("*.so"))


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two fresh processes that find no library both compile it into the
    same (empty) build directory at once; each loads a whole library, and
    only the library is left there."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from vector_database_tpu_torch.runtime import native_store as ns\n"
        "ns._BUILD_DIR = Path(sys.argv[1])\n"
        "st = ns.NativeVectorStore.create(sys.argv[2], dims=3)\n"
        "st.append([[1.0, 2.0, 3.0]])\n"
        "assert st.read(0, 1).tolist() == [[1.0, 2.0, 3.0]]\n"
        "st.close()\n"
    )
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(build), str(tmp_path / f"s{i}")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert [f.name for f in build.iterdir()] == [
        native_store.library_path().name]
