"""Run a JAX harness of ``benchmarks/`` in the test process: loaded by
path (``benchmarks/`` is no package), its ``main()`` called with
``sys.argv`` and the environment patched, its standard output returned.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]


def run(name, argv, env=None):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["harness", *argv]), \
            mock.patch.dict(os.environ, env or {}), \
            contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def port(main, argv, env=None):
    """The same for a port's ``main(argv)``."""
    out = io.StringIO()
    with mock.patch.dict(os.environ, env or {}), \
            contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]
