"""Read the numbers that decide ``correct`` for one cell over many seeds,
with the program or a control in the program's place.

    python -m vdb_bench.control --workload <cell> --seeds 11,12,13 \\
        --control <int8f|program|int8-reference|fp8-reference> \\
        [--seconds 2]

Each seed runs the rest of a run as it is (set-up, a window of
``--seconds`` at the cell's own load, the judging of every answer), in
this one process, and prints one JSON line: the seed and each compared
number with its limit. Controls (``README.md``):

- ``int8f``: the control, the program with its own path of the
  precision below the configuration's bfloat16 switched on
  (``pack_dtype="int8f"``: int8 blocks, the same kernel and rerank);
- ``program``: the program as the cell runs it (the lower readings);
- ``int8-reference`` and ``fp8-reference``: a precision fault, the
  plain reference computed in int8 or float8 e4m3 and put in the
  program's place, with no shortlist and no exact rerank (the traffic
  kind's ``control_system``; ``reference.knn.LowReference``): the upper
  readings of the numbers that the control leaves alone.

The benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from vdb_bench import core
from vdb_bench.run import run_cell


CONTROLS = {
    "int8f": ({"config": {"pack_dtype": "int8f"}}, None),
    "program": ({}, None),
    "int8-reference": ({}, "int8"),
    "fp8-reference": ({}, "fp8"),
}


def read(cell: str, seed: int, control: str, seconds: float,
         dev: torch.device, overrides: dict | None = None) -> dict:
    """One seed's compared numbers with ``control`` in the program's
    place."""
    extra, fmt = CONTROLS[control]
    merged = {part: dict(keys) for part, keys in extra.items()}
    for part, keys in (overrides or {}).items():
        merged.setdefault(part, {}).update(keys)
    kind = core.load_cell(cell).kind()
    hook = None if fmt is None else (
        lambda state: kind.control_system(state, fmt))
    line = run_cell(cell, seed, seconds, False, dev, overrides=merged,
                    system_hook=hook)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "control": control, "correct": line["correct"],
            "attempted": line["attempted"], "checks": line["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one reading each")
    ap.add_argument("--control", choices=list(CONTROLS), default="int8f")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    core.pin_environment()
    if not torch.cuda.is_available():
        print("the control is read on a card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read(args.workload, seed, args.control,
                              args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
