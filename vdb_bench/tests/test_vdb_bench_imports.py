"""Nothing a run loads is JAX or the JAX package, and the reference
loads nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vdb_bench import core

REF = core.PKG / "reference"


def test_forbidden_names_compare_whole(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in core.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vector_database_tpu_torch.fake", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vector_database_tpu.ops.fake", sys)
    assert "vector_database_tpu" in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib_fake", sys)
    assert "jaxlib_fake" not in core.forbidden_modules()


_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from vdb_bench.run import run_cell
from vdb_bench.tests.cpu_sizes import CPU, PRUNED, overrides
import vdb_bench.control
run_cell("deep96.serve-full", 3, 0.0, True, CPU,
         overrides=overrides("deep96.serve-full"))
run_cell("deep96.serve-full", 3, 0.0, True, CPU,
         overrides={part: dict(keys) for part, keys in PRUNED.items()})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _RUN], cwd=core.ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(core.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(__import__("json").loads(out.stdout.splitlines()[-1]))
    assert "vector_database_tpu_torch" in names  # the program ran
    assert not names & set(core.FORBIDDEN), names & set(core.FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REF.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {core.PROGRAM, *core.FORBIDDEN}, tops
    assert tops <= {"__future__", "contextlib", "torch"}, tops


def test_the_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "vdb_bench.run", "--workload",
         "deep96.serve-full", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_cli_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copytree(core.PKG, tmp_path / core.PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "vdb_bench.run", "--workload",
         "sift128.serve-full", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "not in this checkout" in out.stderr
