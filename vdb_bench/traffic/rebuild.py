"""``rebuild``: time to a fresh index, in a closed loop.

One operation: fresh rows from the configuration's recipe, seeded by the
operation's index and drawn on the card; ``build_index_fused`` over them;
``pack_database`` of its leaf-major matrix; a synchronise, after which the
index could serve. The next operation starts when one ends. Set-up draws
the recipe's centres and runs one operation of the window's shape, with
one request served from it, so that every kernel is built.

End-to-end: ``build_vps``, the rows indexed (built and packed) over the
window, from its start to the last operation's end. Spans: ``build`` and
``pack``, the host clock around each call, each ending in a synchronise
(``build_ms`` and ``pack_ms`` read their medians).

``correct``: every operation's node table and ``orig_row`` are held to
the rows it was given (``reference.tree``: ``tree_faults``, limit 0);
one operation drawn from the seed among the first ``SAMPLE_OPS`` keeps
its whole index, whose leaf-major matrix must be those rows in
``orig_row``'s order bit for bit (``matrix_mismatch``, limit 0), and,
after the window, serves one request of the configuration's queries,
judged as a serving cell's answers are (``vdb_bench.correct``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
import torch

from vdb_bench import trace as T
from vdb_bench.core import ProgramServer, Result, Run, sync
from vdb_bench.correct import judge
from vdb_bench.recipe import Recipe, draw, stream_seed, styled
from vdb_bench.reference.knn import LowReference
from vdb_bench.reference.tree import tree_faults

SAMPLE_OPS = 3
TREE = ("orig_row", "dim", "mid", "low", "high", "leaf_start", "leaf_count")


class ProgramBuilder:
    """The system under test: the program's build, pack and server."""

    def __init__(self, cfg: dict, dev: torch.device):
        self.cfg, self.dev = cfg, dev

    def build(self, rows):
        from vector_database_tpu_torch import build_index_fused
        return build_index_fused(rows, leaf_size=self.cfg["leaf_size"],
                                 device=self.dev)

    def pack(self, index):
        from vector_database_tpu_torch import pack_database
        return pack_database(index.vectors, metric=self.cfg["metric"],
                             buckets=self.cfg["buckets"],
                             dtype=self.cfg["pack_dtype"])

    def serve(self, index, pack, rows, queries):
        """Host queries in, ``(ids, dist)`` of the caller's rows out."""
        from vector_database_tpu_torch import PackedServer
        server = PackedServer(pack, k=self.cfg["k"])
        return ProgramServer(server, index.orig_row, pack.block).query(
            queries)


class ControlBuilder(ProgramBuilder):
    """The control: the program's build and pack, but the answers served
    from them computed by the reference in a lower precision."""

    def __init__(self, inner: ProgramBuilder, fmt: str):
        super().__init__(inner.cfg, inner.dev)
        self.fmt = fmt

    def serve(self, index, pack, rows, queries):
        low = LowReference(rows, self.cfg["metric"], self.cfg["k"], self.fmt)
        return low.query(queries)


@dataclasses.dataclass
class State:
    recipe: Recipe
    system: object
    sample: int  # the operation whose whole index is kept
    metric: str
    k: int
    trees: list = dataclasses.field(default_factory=list)
    kept: tuple = None  # (index, pack) of the sampled operation
    spans: dict = dataclasses.field(default_factory=dict)


def op_rows(state: State, j: int) -> torch.Tensor:
    """Operation ``j``'s rows: the recipe over the run's centres, from a
    generator of the operation's own."""
    rec = state.recipe
    g = torch.Generator(device=rec.dev).manual_seed(
        stream_seed(rec.seed, "rebuild", j))
    return styled(draw(g, rec.cent, rec.n), rec.style)


def setup(run: Run) -> State:
    cfg = run.cell.config
    rng = np.random.Generator(np.random.PCG64(stream_seed(run.seed, "op")))
    state = State(recipe=Recipe(cfg, run.seed, run.dev),
                  system=ProgramBuilder(cfg, run.dev),
                  sample=int(rng.integers(SAMPLE_OPS)),
                  metric=cfg["metric"], k=cfg["k"])
    rows = op_rows(state, -1)
    index = state.system.build(rows)
    pack = state.system.pack(index)
    state.system.serve(index, pack, rows,
                       state.recipe.queries(-1, 64).cpu().numpy())
    sync(run.dev)
    return state


def window(run: Run, state: State) -> Result:
    sys_ = state.system
    spans = {"build": [], "pack": []}
    traced_ops = 0
    tracer = T.Tracer(run.dev, run.traced)
    t_start = time.perf_counter()
    j = failed = rows_done = 0
    while j == 0 or time.perf_counter() - t_start < run.seconds:
        with T.span("client.rows"):
            rows = op_rows(state, j)
        index = pack = None
        try:
            t0 = time.perf_counter()
            with T.span("build"):
                index = sys_.build(rows)
                sync(run.dev)
            t1 = time.perf_counter()
            with T.span("pack"):
                pack = sys_.pack(index)
                sync(run.dev)
            t2 = time.perf_counter()
        except Exception:
            if failed == 0:
                traceback.print_exc()
            failed += 1
            state.trees.append(None)
        else:
            if not tracer.running:  # spans outside the traced seconds
                spans["build"].append(t1 - t0)
                spans["pack"].append(t2 - t1)
            state.trees.append({key: getattr(index, key) for key in TREE})
            if j == state.sample:
                state.kept = (index, pack)
            rows_done += rows.shape[0]
        del rows, index, pack
        j += 1
        if tracer.running:
            traced_ops = j
            tracer.stop_after(time.perf_counter() - t_start)
    t_end = time.perf_counter()
    tracer.stop()
    summary = tracer.summary()
    if summary is not None:
        summary.kind = "rebuild"
        summary.requests = traced_ops
        summary.spans = {k: v for k, v in spans.items() if v}
    print(f"window: {j} operations, {rows_done} rows indexed in "
          f"{t_end - t_start:.3f} s", file=sys.stderr)
    return Result(attempted=j, failed=failed,
                  end_to_end={"build_vps": rows_done / (t_end - t_start)},
                  summary=summary)


def check(run: Run, state: State, result: Result) -> dict:
    cfg, spec = run.cell.config, run.cell.spec["checks"]
    faults = 0
    for j, tree in enumerate(state.trees):
        if tree is not None:
            faults += tree_faults(op_rows(state, j), tree, cfg["leaf_size"])
    rows = op_rows(state, state.sample)
    if state.kept is None or state.sample >= len(state.trees):
        mismatch, answers = rows.shape[0], [None]
    else:
        index, pack = state.kept
        o = index.orig_row.to(torch.int64)
        mismatch = int((index.vectors != rows[o.clamp(0, rows.shape[0] - 1)])
                       .any(dim=1).sum()) if index.vectors.shape == \
            rows.shape and o.shape == (rows.shape[0],) else rows.shape[0]
        queries = state.recipe.queries(0, cfg["queries"])
        try:
            ids, dist = state.system.serve(index, pack, rows,
                                           queries.cpu().numpy())
            answers = [(np.asarray(ids), np.asarray(dist))]
        except Exception:
            traceback.print_exc()
            answers = [None]
    state.kept = None
    state.trees = []
    out = {
        "tree_faults": (faults, spec["tree_faults"],
                        faults <= spec["tree_faults"]),
        "matrix_mismatch": (mismatch, spec["matrix_mismatch"],
                            mismatch <= spec["matrix_mismatch"]),
    }
    out.update(judge(rows, cfg["metric"], cfg["k"], answers,
                     lambda i: state.recipe.queries(0, cfg["queries"]),
                     spec, run.seed))
    return out


def control_system(state: State, fmt: str):
    """The system with the reference, in ``fmt``, serving in its place."""
    return ControlBuilder(state.system, fmt)
