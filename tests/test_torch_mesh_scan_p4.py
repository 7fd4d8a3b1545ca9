"""The port's sharded packed scan against the JAX package's at 4 Gloo
ranks (the tests are in ``torch_mesh_scan_tests.py``)."""

import pytest

from torch_mesh_scan_tests import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def world():
    return 4
