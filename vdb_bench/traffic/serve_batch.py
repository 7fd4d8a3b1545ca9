"""``serve_batch``: batch k-NN requests from one closed-loop client.

The client sends a request, waits for its answer, and sends the next, as
a batch caller does (ann-benchmarks' batch mode). A request is
``request_queries`` fresh queries drawn from the configuration's recipe
with a generator of its own, so no query repeats within a run. It goes
in as a host numpy array, through ``PackedServer.query`` (``wave``,
``probes`` and ``probes_max`` from the mix; ``wave`` null is the front
end's default wave of 1024 queries), and ends when the ids, mapped to the
caller's rows through the built index's ``orig_row``, and the distances
are on the host. The client draws request ``i + 1``'s queries while
request ``i`` is served (``Client``), so its own work neither lengthens a
request nor stands between two.

Set-up: the rows are drawn on the card, ``build_index_fused`` builds the
index and ``pack_database`` packs its leaf-major matrix; two requests of
the window's shape warm every kernel. End-to-end metrics: ``qps`` (the
queries answered over the window, from its start to the last answer) and
``p95_ms`` (the 95th percentile of every request's latency).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback

import numpy as np
import torch

from vdb_bench import trace as T
from vdb_bench.core import ProgramServer, Result, Run, sync
from vdb_bench.correct import judge
from vdb_bench.recipe import Recipe
from vdb_bench.reference.knn import LowReference

WARM_REQUESTS = 2


class Client:
    """The client's own work, off the requests' path: request ``i``'s
    queries are drawn on the card, on a stream of the client's own, and
    copied into the page-locked host buffer ``i % 2`` while request
    ``i - 1`` is served; ``take(i)`` hands them over as a host array."""

    def __init__(self, recipe: Recipe, count: int, dev: torch.device):
        self.recipe, self.count = recipe, count
        card = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if card else None
        self.bufs = [torch.empty((count, recipe.d), pin_memory=card)
                     for _ in range(2)]
        self.pending = {}  # request -> (its queries on the card, done)

    def prepare(self, i: int) -> None:
        """Start drawing request ``i``'s queries into its buffer."""
        with T.span("client.prepare"), (
                torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext()):
            x = self.recipe.queries(i, self.count)
            self.bufs[i % 2].copy_(x, non_blocking=self.stream is not None)
            done = None
            if self.stream is not None:
                done = torch.cuda.Event()
                done.record(self.stream)
        self.pending[i] = (x, done)

    def take(self, i: int) -> np.ndarray:
        """Request ``i``'s queries on the host, once they are there."""
        _, done = self.pending.pop(i)
        if done is not None:
            done.synchronize()
        return self.bufs[i % 2].numpy()

    def close(self) -> None:
        for _, done in self.pending.values():
            if done is not None:
                done.synchronize()
        self.pending.clear()


@dataclasses.dataclass
class State:
    recipe: Recipe
    rows: torch.Tensor  # the benchmark's own copy of the database
    system: object
    count: int  # queries a request
    metric: str
    k: int
    client: Client = None
    answers: list = dataclasses.field(default_factory=list)


def build_system(run: Run, rows: torch.Tensor):
    """The program over ``rows``: built, packed and behind its server."""
    from vector_database_tpu_torch import (
        PackedServer,
        build_index_fused,
        pack_database,
    )

    cfg, mix = run.cell.config, run.cell.mix
    index = build_index_fused(rows, leaf_size=cfg["leaf_size"],
                              device=run.dev)
    pack = pack_database(index.vectors, metric=cfg["metric"],
                         buckets=cfg["buckets"],
                         dtype=cfg["pack_dtype"])
    orig_row = index.orig_row
    del index  # serving keeps the pack (and its f32 rows) and orig_row
    wave = {} if mix["wave"] is None else {"batch": mix["wave"]}
    server = PackedServer(pack, k=cfg["k"], probes=mix["probes"],
                          probes_max=mix["probes_max"], **wave)
    return ProgramServer(server, orig_row, pack.block)


def setup(run: Run) -> State:
    recipe = Recipe(run.cell.config, run.seed, run.dev)
    rows = recipe.rows()
    count = int(run.cell.mix["request_queries"])
    cfg = run.cell.config
    state = State(recipe=recipe, rows=rows, system=build_system(run, rows),
                  count=count, metric=cfg["metric"], k=cfg["k"],
                  client=Client(recipe, count, run.dev))
    # the warm requests go through the client as the window's do
    for j in range(WARM_REQUESTS):
        state.client.prepare(-1 - j)
        state.system.query(state.client.take(-1 - j))
    state.client.prepare(0)
    sync(run.dev)
    return state


def window(run: Run, state: State) -> Result:
    lat, answered, failed = [], 0, 0
    traced_queries = traced_requests = 0
    tracer = T.Tracer(run.dev, run.traced)
    t_start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t_start < run.seconds:
        with T.span("client.queries"):
            queries = state.client.take(i)
        state.client.prepare(i + 1)
        t0 = time.perf_counter()
        try:
            with T.span("request"):
                ids, dist = state.system.query(queries)
            ans = (np.asarray(ids), np.asarray(dist))
        except Exception:
            if failed == 0:
                traceback.print_exc()
            ans = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        state.answers.append(ans)
        if ans is None or ans[0].shape != (state.count, state.k):
            failed += 1
        else:
            answered += state.count
        i += 1
        if tracer.running:
            traced_queries, traced_requests = answered, i - failed
            tracer.stop_after(t1 - t_start)
    t_end = time.perf_counter()
    tracer.stop()
    state.client.close()
    summary = tracer.summary()
    if summary is not None:
        summary.kind = "serve_batch"
        summary.queries = traced_queries
        summary.requests = traced_requests
        summary.work = _work(run, state)
    e2e = {
        "qps": answered / (t_end - t_start),
        "p95_ms": float(np.percentile(np.asarray(lat), 95)) * 1e3,
    }
    print(f"window: {i} requests, {answered} queries answered in "
          f"{t_end - t_start:.3f} s", file=sys.stderr)
    return Result(attempted=i, failed=failed, end_to_end=e2e,
                  summary=summary)


def _work(run: Run, state: State) -> dict:
    """The sizes that count the scan's work: the data's own, never the
    pack's padded width."""
    cfg, mix = run.cell.config, run.cell.mix
    block = getattr(state.system, "block", None)
    return {"n": int(cfg["n"]), "d": int(cfg["d"]), "m": int(cfg["buckets"]),
            "k": int(cfg["k"]), "probes": mix["probes"], "block": block}


def check(run: Run, state: State, result: Result) -> dict:
    """Frees the program's state, then judges every answer."""
    state.system = state.client = None
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    return judge(state.rows, state.metric, state.k, state.answers,
                 lambda i: state.recipe.queries(i, state.count),
                 run.cell.spec["checks"], run.seed)


def control_system(state: State, fmt: str):
    """The reference, in ``fmt``, in the program's place (the program's
    state is dropped first)."""
    state.system = None
    if state.rows.is_cuda:
        torch.cuda.empty_cache()
    return LowReference(state.rows, state.metric, state.k, fmt)
