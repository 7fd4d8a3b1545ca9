"""Tracing, profiling and observability utilities (port of
``vector_database_tpu/utils/profiling.py``).

The reference's observability is Stopwatch spans and throttled console
progress (IndexBuilder.cs:43-53, Program.cs:36-52). Here:

- ``span``/``spanned``: a named ``torch.profiler.record_function`` range
  around a layer of the program while a profiler runs, and nothing
  otherwise (the program's names start with ``vdb_torch.``);
- ``COUNTERS``: process-wide counts the serving and scan paths keep
  always (one integer add a site);
- ``BuildStats``: per-level build telemetry collected through the
  builder's progress hook (level, live ranges, active points, time
  between callbacks: the card's, from CUDA events, or the host's);
- ``ProgressLogger``: the reference's throttled progress print;
- ``trace``: a ``torch.profiler`` trace of the block (host and, where
  there is a card, device timeline), written as a Chrome trace; unlike the
  JAX package's ``trace``, which swallows every failure, a profiler that
  fails raises;
- ``selectivity_report``: candidates examined per match, the
  generalization of the reference tests' predicate-call counters
  (MemoryVectorIndexTests.cs:191-196).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# Process-wide counts, never reset by the program (readers take
# differences): the scan kernels' launches by pack form, the queries the
# exact rerank took and the shortlist rows it gathered, the real
# queries served and the wave slots they filled (``PackedServer.query``),
# the segment-moments kernel's launches (one a level of a fused build
# on the card), and ``DynamicIndex``'s mutations: rows added and removed,
# rebuilds of its main view, the live delta rows merged and the padded
# delta capacity they were merged in (summed over merges), compactions,
# and the delta k-NN kernels' launches (two a pass of 128 places of a
# merge on the card: the pass and the join of its splits).
COUNTERS = dict.fromkeys((
    "scan.launches.bf16",
    "scan.launches.int8f",
    "scan.launches.int8",
    "scan.launches.uint8",
    "knn.shortlist_queries",
    "knn.shortlist_rows",
    "serve.queries",
    "serve.slots",
    "build.moments.launches",
    "dynamic.rows_added",
    "dynamic.rows_removed",
    "dynamic.main_views",
    "dynamic.delta_rows",
    "dynamic.delta_slots",
    "dynamic.compactions",
    "dynamic.delta_knn.launches",
), 0)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs, else one shared no-op context (no ``RecordFunction`` is made:
    the check is one flag read). The range lies on the profiler's clock,
    beside the device operations launched inside it."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@dataclass
class LevelStat:
    level: int
    live_ranges: int
    active_points: int
    seconds: float


class BuildStats:
    """Collects per-level timings via ``progress=stats`` of
    ``build_index`` or ``build_index_fused``.

    Each callback marks the time, and a level's ``seconds`` is the time
    from the previous mark (construction, for the first callback) to its
    own. ``build_index`` calls AFTER level ``level``'s device pass, so the
    row is that level's own pass; ``build_index_fused`` calls at the START
    of each level, so its row ``level`` holds the pass of level
    ``level - 1`` (row 0 the work before the first level), and the last
    level's pass, after the last call, is in no row. Create the instance
    immediately before the build.

    On a machine with a card a mark is a CUDA event recorded on the
    current device's current stream, where the build runs: the times are
    the card's, read once when ``levels`` is read after the build, and
    the callbacks add no synchronise. Without a card a mark is the host's
    clock."""

    def __init__(self):
        self._card = torch.cuda.is_available()
        self._calls = []  # (level, live, active)
        self._marks = [self._mark()]
        self._levels: List[LevelStat] = []

    def _mark(self):
        if not self._card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, level: int, live: int, active: int) -> None:
        self._calls.append((level, live, active))
        self._marks.append(self._mark())

    @property
    def levels(self) -> List[LevelStat]:
        if len(self._levels) < len(self._calls):
            marks = self._marks
            if self._card:
                marks[-1].synchronize()
            for i in range(len(self._levels), len(self._calls)):
                a, b = marks[i], marks[i + 1]
                sec = (a.elapsed_time(b) / 1e3 if self._card else b - a)
                self._levels.append(LevelStat(*self._calls[i], sec))
        return self._levels

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.levels)

    def report(self) -> str:
        lines = ["level  ranges    active     seconds"]
        for s in self.levels:
            lines.append(
                f"{s.level:>5}  {s.live_ranges:>7}  {s.active_points:>9}"
                f"  {s.seconds:>9.4f}"
            )
        return "\n".join(lines)


class ProgressLogger:
    """Throttled build progress print (IndexBuilder.cs:43-53)."""

    def __init__(self, every: int = 1):
        self.every = every

    def __call__(self, level: int, live: int, active: int) -> None:
        if level % self.every == 0:
            print(f"Process level {level}: {live} ranges, "
                  f"{active} active points")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, CPU activity and, where a
    CUDA device is present, the card's; on exit the Chrome trace is written
    to ``log_dir/trace_<pid>_<ns>.json`` (the profiler object is yielded:
    ``key_averages()`` sums the time by operator). Failures of the
    profiler raise."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


def selectivity_report(result, n: int) -> dict:
    """Candidates-per-match statistics for a ``SearchResult`` over an
    ``n``-vector index."""

    def host(x):
        return (x.cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)).astype(np.float64)

    cand = host(result.candidates)
    matches = host(result.count)
    per_match = cand / np.maximum(matches, 1)
    return {
        "queries": int(cand.shape[0]),
        "mean_candidates": float(cand.mean()),
        "candidate_fraction": float(cand.mean() / n),
        "mean_matches": float(matches.mean()),
        "candidates_per_match": float(per_match.mean()),
        "overflowed": int(host(result.overflow).sum()),
    }
