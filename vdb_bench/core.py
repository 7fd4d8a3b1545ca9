"""Finding a cell's files by name, and the run's result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent  # the checkout: BENCHMARK.json and the program
FORBIDDEN = ("jax", "jaxlib", "flax", "vector_database_tpu")
PROGRAM = "vector_database_tpu_torch"
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
# where the run keeps the caches of the libraries it loads: fixed paths
# inside the checkout, so that only a checkout's first run builds
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "build/vdb_bench/triton",
    "TORCH_EXTENSIONS_DIR": "build/vdb_bench/torch_extensions",
    "CUDA_CACHE_PATH": "build/vdb_bench/cuda_cache",
}


def pin_environment() -> None:
    """The run's fixed surroundings: the libraries' caches at fixed paths
    inside the checkout, and one host thread (the request path's host
    work is one Python thread, and the card's host shares its cores)."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    for var in THREAD_VARS:
        os.environ[var] = "1"
    torch.set_num_threads(1)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    """The Python file at ``path``, loaded once (under a name made from
    its path, so two checkouts' files never share a module)."""
    name = "vdb_bench._file_" + _safe(str(path))
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Run:
    """One run of a cell: what its traffic kind is given."""

    cell: "Cell"
    seed: int
    seconds: float
    traced: bool
    dev: torch.device


@dataclasses.dataclass
class Result:
    """A window's outcome: operations attempted and failed, the
    end-to-end metrics, and with a trace its summary."""

    attempted: int
    failed: int
    end_to_end: dict
    summary: object = None


@dataclasses.dataclass
class Cell:
    """One cell with every file it names, read by name."""

    name: str
    pkg: Path  # the benchmark's folder the cell was read from
    entry: dict  # the cell's entry in BENCHMARK.json
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def kind(self):
        """The traffic kind's generator, ``traffic/<kind>.py``."""
        return _module(self.pkg / "traffic" / f"{self.mix['kind']}.py")

    def metric_reader(self, name: str):
        """A per-layer metric's reader, ``metrics/<name>.py``."""
        return _module(self.pkg / "metrics" / f"{name}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[name]
    pkg = root / PKG.name
    spec = load_json(pkg / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(
                f"workloads/{name}.json gives {key}={spec[key]!r}, "
                f"BENCHMARK.json {entry[key]!r}")
    return Cell(
        name=name, pkg=pkg, entry=entry, spec=spec,
        config=load_json(pkg / "configs" / f"{entry['config']}.json"),
        mix=load_json(pkg / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def sync(dev: torch.device) -> None:
    """Wait for the card's work (nothing to wait for on the host)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ProgramServer:
    """The program's server as a client sees it: host queries in,
    ``(ids int32 [q, k], dist float32 [q, k])`` on the host out, the ids
    mapped to the caller's rows through the built index's ``orig_row``."""

    def __init__(self, server, orig_row, block: int):
        self.server, self.orig_row = server, orig_row
        self.block = block  # rows a packed block holds (counts the work)

    def query(self, queries):
        rows, dist = self.server.query(queries)
        ids = torch.where(rows >= 0, self.orig_row[rows.clamp(min=0)], -1)
        return ids.cpu(), dist.cpu()


def seconds_since_start() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``vector_database_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi: {e})"
    return out[dev.index or 0].strip() if out else "?"


def device_block(dev: torch.device, chips: int, power: str) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0, "card": power}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak), "card": power}
