"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into a shared library of
its own with a plain C interface, under ``build/vector_database_tpu_torch/``
(listed in ``.gitignore``). The file name carries a hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edit rebuilds and an
unchanged source builds once. Nothing here runs at import: a library is
built at its first use, or up front with ``build(*names)``, which starts one
``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "vector_database_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may claim
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
        "toolkit is needed to build the kernels in csrc/"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256()
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(*names: str) -> list[Path]:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all started together; return the libraries' paths."""
    outs = [library_path(name) for name in names]
    todo = [(name, out) for name, out in zip(names, outs) if not out.exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out, subprocess.Popen(cmd)))
    failed = []
    for name, tmp, out, proc in jobs:
        if proc.wait() == 0:
            # atomic: a concurrent process never loads a partly written file
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed to build csrc/{failed}")
    return outs


def load(name: str, declare) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use;
    ``declare(lib)`` sets its functions' ``argtypes``/``restype`` once."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)[0]))
        declare(lib)
        _libs[name] = lib
    return _libs[name]

