"""The port's HDF5 harnesses against the JAX harnesses: ``make_hdf5``
writes the same arrays for every ``--style`` (bitwise), and
``main_test``'s CSV export of an HDF5 dataset is the same file byte for
byte. The dataset's rows are small integers, on which both packages
build the same tree (on float data a plane may differ in its last ulp:
the port's prefix sums add in another order). Both harnesses also build
the reference's 10k x 1536 random set and the one-hot 1536 set first.
"""

import h5py
import numpy as np
import pytest
import torch

from jax_harness import port, run
from vector_database_tpu_torch.benchmarks import main_test, make_hdf5

torch.set_num_threads(2)


@pytest.mark.parametrize("style", ["deep", "glove", "sift"])
def test_make_hdf5_arrays_equal_jax(tmp_path, style):
    args = ["--style", style, "--n", "2500", "--q", "50", "--seed", "3"]
    run("make_hdf5", [str(tmp_path / "jax.hdf5"), *args])
    port(make_hdf5.main, [str(tmp_path / "port.hdf5"), *args,
                          "--device", "cpu"])
    with h5py.File(tmp_path / "jax.hdf5") as a, \
            h5py.File(tmp_path / "port.hdf5") as b:
        for name in ("train", "test"):
            x, y = np.asarray(a[name]), np.asarray(b[name])
            assert x.dtype == y.dtype == np.float32
            assert x.shape == y.shape
            assert np.array_equal(x.view(np.uint32), y.view(np.uint32))


def test_main_test_csv_export_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    train = rng.randint(0, 24, size=(3000, 12)).astype(np.float32)
    data = tmp_path / "ints.hdf5"
    with h5py.File(data, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("test", data=train[:10])
    text = run("main_test", [str(data), str(tmp_path / "jax.csv")])
    got_text = port(main_test.main, [str(data), str(tmp_path / "port.csv"),
                                     "--device", "cpu"])
    want = (tmp_path / "jax.csv").read_bytes()
    assert want.startswith(b"RangeID,Dimension,Mid,ID\n")
    assert want.count(b"\n") > 100
    assert (tmp_path / "port.csv").read_bytes() == want
    # the same three builds, the same trees
    shape = [x.split(": build")[1].split(", ", 1)[1]
             for x in text.splitlines() if ": build" in x]
    got = [x.split(": build")[1].split(", ", 1)[1]
           for x in got_text.splitlines() if ": build" in x]
    assert len(got) == 3 and got[1:] == shape[1:]
