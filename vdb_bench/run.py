"""Run one cell of the benchmark once and print its result line.

    python -m vdb_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program
(``vector_database_tpu_torch``). The run draws its data from ``--seed``,
sets up and warms the program, measures for ``--seconds``, judges every
answer of the window against the plain reference, and prints one JSON
object as the last line of standard output (``README.md``). With
``--trace 1`` the window's first seconds are traced and the line carries
the cell's per-layer metrics in place of its end-to-end ones. Without a
card, with fewer cards than the cell asks for, without the program in the
checkout, or with JAX loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

from vdb_bench import core


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             dev: torch.device, *, overrides: dict | None = None,
             system_hook=None, root=core.ROOT) -> dict:
    """One run of cell ``name`` on ``dev``: the result line as a dict.

    ``overrides`` (``{"config": {...}, "mix": {...}}``) replace keys
    of the cell's files and ``system_hook(state) -> system`` replaces
    the system the window drives: both are for the tests and the control,
    which run the rest of a run as it is."""
    cell = core.load_cell(name, root)
    for part, keys in (overrides or {}).items():
        getattr(cell, part).update(keys)
    power = core.card_line(dev)
    print(f"card: {power}", file=sys.stderr, flush=True)
    kind = cell.kind()
    run = core.Run(cell=cell, seed=seed, seconds=seconds, traced=traced,
                   dev=dev)
    state = kind.setup(run)
    if system_hook is not None:
        state.system = system_hook(state)
    setup_s = core.seconds_since_start()
    res = kind.window(run, state)
    device = core.device_block(dev, cell.chips, power)
    checks = kind.check(run, state, res)

    metrics = {}
    if traced:
        summary = res.summary
        print(f"trace: {len(summary.device_ops)} device operations of the "
              f"program, {summary.client_ops} of the client left out",
              file=sys.stderr)
        device["busy_s"] = summary.busy_s()
        device["window_s"] = summary.window_s
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {
        "correct": res.failed == 0 and all(ok for _, _, ok in
                                           checks.values()),
        "attempted": res.attempted,
        "failed": res.failed,
        "metrics": metrics,
        "device": device,
    }
    if traced:
        line["breakdown"] = {
            "device_ops": summary.device_totals()[:10],
            "idle_gaps": summary.idle_by_host()[:10],
        }
    # the numbers compared with their limits, last
    line["checks"] = {key: {"value": v, "limit": lim}
                      for key, (v, lim, _) in checks.items()}
    for key, (v, lim, ok) in checks.items():
        print(f"check {key}: {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.pin_environment()

    cell = core.load_cell(args.workload)
    try:
        import vector_database_tpu_torch as program
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 3
    where = os.path.realpath(program.__file__)
    if not where.startswith(str(core.ROOT) + os.sep):
        print(f"the program was loaded from {where}, outside the checkout "
              f"{core.ROOT}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0))
    except Exception:
        traceback.print_exc()
        return 1
    bad = core.forbidden_modules()
    if bad:
        print(f"JAX was loaded in this process: {bad}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
