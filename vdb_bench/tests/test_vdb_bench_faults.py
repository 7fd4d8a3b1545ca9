"""A run with the timed path broken underneath comes out not correct, for
each fault a serving cell can have."""

import pytest
import torch

from vdb_bench.run import run_cell
from vdb_bench.tests.cpu_sizes import (
    CPU,
    REBUILD_SECONDS,
    SECONDS,
    overrides,
)


class _Altered:
    """One answer altered where it is produced: an id moved by one."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def query(self, queries):
        ids, dist = self.inner.query(queries)
        self.calls += 1
        if self.calls == 1:
            ids = ids.clone()
            ids[len(ids) // 2, 3] += 1
        return ids, dist


class _HalfBatch:
    """Half of the batch left out."""

    def __init__(self, inner):
        self.inner = inner

    def query(self, queries):
        ids, dist = self.inner.query(queries[: len(queries) // 2])
        return ids, dist


class _Stale:
    """The state returned unchanged: every request after the first gets
    the first one's answer."""

    def __init__(self, inner):
        self.inner, self.first = inner, None

    def query(self, queries):
        if self.first is None:
            self.first = self.inner.query(queries)
        return self.first


class _Raises:
    def __init__(self, inner):
        pass

    def query(self, queries):
        raise RuntimeError("the scan failed")


@pytest.mark.parametrize("fault", [_Altered, _HalfBatch, _Stale, _Raises])
@pytest.mark.parametrize("name", ["deep96.serve-full", "sift128.serve-full"])
def test_fault_is_not_correct(fault, name):
    line = run_cell(name, 23, 1.0, False, CPU,
                    overrides=overrides(name),
                    system_hook=lambda state: fault(state.system))
    assert line["attempted"] >= 2
    assert line["correct"] is False


def test_sound_run_is_correct():
    name = "deep96.serve-full"
    line = run_cell(name, 23, SECONDS, False, CPU, overrides=overrides(name))
    assert line["correct"] is True
    assert torch.isfinite(torch.tensor(
        line["checks"]["dist_rel_err"]["value"]))


class _StaleBuild:
    """A build that returns its state unchanged: every operation after
    the first hands back the first operation's index."""

    def __init__(self, inner):
        self.inner, self.first = inner, None
        self.pack, self.serve = inner.pack, inner.serve

    def build(self, rows):
        if self.first is None:
            self.first = self.inner.build(rows)
        return self.first


class _HalfBuild:
    """Half of the rows left out of the build."""

    def __init__(self, inner):
        self.inner = inner
        self.pack, self.serve = inner.pack, inner.serve

    def build(self, rows):
        return self.inner.build(rows[: len(rows) // 2])


class _AlteredBuild:
    """One row id altered where the build produces it."""

    def __init__(self, inner):
        self.inner = inner
        self.pack, self.serve = inner.pack, inner.serve

    def build(self, rows):
        index = self.inner.build(rows)
        index.orig_row[7] = index.orig_row[8]
        return index


class _RaisingBuild(_HalfBuild):
    def build(self, rows):
        raise RuntimeError("the build failed")


@pytest.mark.parametrize("fault", [_StaleBuild, _HalfBuild, _AlteredBuild,
                                   _RaisingBuild])
def test_rebuild_fault_is_not_correct(fault):
    name = "deep96.rebuild"
    line = run_cell(name, 29, REBUILD_SECONDS, False, CPU,
                    overrides=overrides(name),
                    system_hook=lambda state: fault(state.system))
    assert line["attempted"] >= 2
    assert line["correct"] is False
