"""Tracing, profiling and observability utilities (port of
``vector_database_tpu/utils/profiling.py``).

The reference's observability is Stopwatch spans and throttled console
progress (IndexBuilder.cs:43-53, Program.cs:36-52). Here:

- ``BuildStats``: per-level build telemetry collected through the
  builder's progress hook (level, live ranges, active points, wall time);
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
import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


@dataclass
class LevelStat:
    level: int
    live_ranges: int
    active_points: int
    seconds: float


@dataclass
class BuildStats:
    """Collects per-level timings via ``build_index_fused(progress=stats)``.

    The builder fires ``progress(level, ...)`` AFTER level ``level``'s
    device pass, so the window since the previous callback is that level's
    own duration and is recorded on the stat being appended. Level 0's
    window starts at construction: create the instance immediately before
    the build or its row absorbs the setup time. Device work is
    asynchronous, so a level's window is the host's, up to the builder's
    next synchronising read."""

    levels: List[LevelStat] = field(default_factory=list)
    _t0: float = field(default_factory=time.time)

    def __call__(self, level: int, live: int, active: int) -> None:
        now = time.time()
        self.levels.append(LevelStat(level, live, active, now - self._t0))
        self._t0 = now

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
