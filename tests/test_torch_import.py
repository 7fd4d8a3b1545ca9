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
    "vector_database_tpu_torch.out_of_core",
    "vector_database_tpu_torch.runtime.native_store",
    "vector_database_tpu_torch.models.memindex",
    "vector_database_tpu_torch.models.boolmatrix",
    "vector_database_tpu_torch.utils.arff",
    "vector_database_tpu_torch.utils.profiling",
    "vector_database_tpu_torch.ops.collectives",
    "vector_database_tpu_torch.parallel",
    "vector_database_tpu_torch.parallel.mesh",
    "vector_database_tpu_torch.parallel.global_tree",
    "vector_database_tpu_torch.parallel.forest",
    "vector_database_tpu_torch.parallel.query",
    "vector_database_tpu_torch.parallel.scan",
    "vector_database_tpu_torch.parallel.multislice",
    "vector_database_tpu_torch.ops.level",
    "vector_database_tpu_torch.builder",
    "vector_database_tpu_torch.entry",
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


def test_parallel_names_match_the_jax_package():
    """Every public name of the JAX ``parallel`` package has a
    counterpart in the port's (read from the source: the test process
    keeps the JAX package out of this check's way)."""
    import ast

    import vector_database_tpu_torch.parallel as tp

    src = (REPO / "vector_database_tpu" / "parallel" / "__init__.py")
    tree = ast.parse(src.read_text())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and node.targets[0].id == "__all__")
    assert set(names) <= set(tp.__all__)
    assert all(hasattr(tp, name) for name in names)


def test_mesh_on_cuda_without_a_gpu_raises():
    """No fallback: a ``cuda`` mesh on a machine without a card raises
    before any process group starts."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import torch.distributed as dist

    from vector_database_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        make_mesh()
    assert not dist.is_initialized()


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
