"""The port's sharded global-tree build, and its host-loop build over a
mesh, against the JAX package's at 4 Gloo ranks (the tests are in
``torch_mesh_build_tests.py``)."""

import pytest

from torch_mesh_build_tests import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def world():
    return 4
