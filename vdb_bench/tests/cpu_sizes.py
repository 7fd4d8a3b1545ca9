"""Tiny sizes at which the tests run a cell on the CPU, through the plain
torch versions of the program's kernels."""

import torch

CPU = torch.device("cpu")
SECONDS = 0.3

_POINT = {"config": {"n": 20000, "buckets": 256},
          "mix": {"request_queries": 200}}
# the pruned path of ``serve_batch`` at a size with blocks to skip: 5
# blocks of 8192 rows
PRUNED = {"config": {"n": 40000, "buckets": 256},
          "mix": {"request_queries": 200, "wave": 200, "probes": 4,
                  "probes_max": 5}}


# a rebuild window of a few operations (one of the first three is kept)
_REBUILD = {"config": {"n": 20000, "buckets": 256, "queries": 200}}
REBUILD_SECONDS = 1.5


def overrides(cell: str) -> dict:
    """The keys a test replaces in ``cell``'s files."""
    src = _REBUILD if cell.endswith("rebuild") else _POINT
    return {part: dict(keys) for part, keys in src.items()}
