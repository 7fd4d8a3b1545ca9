"""Importing vector_database_tpu_torch must not import JAX.

Checked in a fresh interpreter: this test process already imported JAX
through ``conftest.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("module", [
    "vector_database_tpu_torch",
    "vector_database_tpu_torch.ops.bucket_scan",
    "vector_database_tpu_torch.ops.packed_knn",
    "vector_database_tpu_torch.ops.bucket_scan_i8",
    "vector_database_tpu_torch.benchmarks.probe_kernel_ab",
    "vector_database_tpu_torch.ops.scan_knn",
    "vector_database_tpu_torch.dynamic",
    "vector_database_tpu_torch.document_store",
])
def test_import_leaves_jax_out(module):
    code = (
        f"import sys, {module}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'vector_database_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """Without CUDA, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
