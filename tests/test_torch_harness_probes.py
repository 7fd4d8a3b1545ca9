"""The last three harness ports (``probe_perm``, ``probe_meanid``,
``probe_sharded_mem``) on the host at a tiny size: the JAX harnesses'
keys, and the equalities each asserts (the three permutation inverses
are one, every ``mean_id`` formulation's segment totals are the int64
sums, the single-device and sharded trees are one), each shown to fire
on a broken input. ``tests/test_torch_harness_run.py`` checks that each
refuses ``--device cuda`` without a card.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from vector_database_tpu_torch.benchmarks import (
    probe_meanid,
    probe_perm,
    probe_sharded_mem,
)

torch.set_num_threads(2)


def _run(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = mod.main(argv + ["--device", "cpu"])
    return out.getvalue().splitlines(), ret


def _json(lines):
    return [json.loads(x) for x in lines if x.startswith("{")]


def test_probe_perm_keys_and_equal_inverses():
    lines, ret = _run(probe_perm, ["40000"])
    first, line = _json(lines)
    assert first == {"device": "cpu"} and line == ret
    assert set(line) == {"n", "scatter_ms", "sort_key_val_ms",
                         "argsort_ms"}
    assert line["n"] == 40000 and all(
        line[k] > 0 for k in line if k.endswith("_ms"))


def test_probe_perm_dest_is_a_stable_partition_per_segment():
    """Each 2^14 segment's rows stay in it, the lows first and then the
    highs, each side in its old order: the inverse rises within a
    segment with one step down at most, where the highs start."""
    n = 40000
    src = np.argsort(probe_perm.partition_dest(n))
    for s in range(0, n, probe_perm.SEG):
        seg = src[s:s + probe_perm.SEG]
        assert seg.min() == s and seg.max() == s + len(seg) - 1
        assert (np.diff(seg) < 0).sum() == 1


def test_probe_perm_refuses_a_wrong_inverse(monkeypatch):
    monkeypatch.setattr(torch, "argsort",
                        lambda d: torch.arange(d.shape[0]).flip(0))
    with pytest.raises(AssertionError, match="argsort != scatter"):
        _run(probe_perm, ["40000"])


def test_probe_meanid_keys_and_exact_variants():
    lines, ret = _run(probe_meanid, ["--n", "30000", "--reps", "2",
                                     "--s-live", "100"])
    first, line = _json(lines)
    assert first == {"device": "cpu"} and line == ret
    variants = ("full_current", "extract_cumsum", "gathers_only", "blocked",
                "stacked", "int64", "positional")
    assert set(line) == {"n", "bits", "limbs", "s_max", "s_live", "B",
                         "variants_exact"} | {f"{v}_ms" for v in variants}
    assert (line["bits"], line["limbs"], line["s_live"]) == (7, 5, 100)
    assert line["s_max"] == 2 * (30000 // 17) and line["B"] == 8
    assert line["variants_exact"] is True


@pytest.mark.parametrize("n", [30000, 30001])
def test_probe_meanid_limb_plan_and_ragged_blocks(n):
    """Wide ids take narrower limbs; a row count that no block of 8
    divides leaves a partial last block; every variant stays exact."""
    assert probe_meanid.id_limb_plan(20_000_000) == (6, 6)
    assert probe_meanid.id_limb_plan(10_000_000) == (7, 5)
    _, line = _run(probe_meanid, ["--n", str(n), "--reps", "1"])
    assert line["variants_exact"] is True and line["s_live"] == line["s_max"]


def test_probe_meanid_refuses_wrong_sums(monkeypatch):
    real = torch.cumsum

    def off_by_one(x, dim, dtype=None):
        out = real(x, dim, dtype=dtype)
        return out + 1 if out.dtype == torch.int32 else out

    monkeypatch.setattr(torch, "cumsum", off_by_one)
    with pytest.raises(AssertionError, match="!= the int64 sums"):
        _run(probe_meanid, ["--n", "30000", "--reps", "1"])


def test_probe_sharded_mem_lines_and_equal_trees():
    lines, ret = _run(probe_sharded_mem, ["--n", "20000", "--d", "16",
                                          "--subsample", "1"])
    assert [x.split(":")[0] for x in lines if not x.startswith("{")] == [
        "single_donate", "sharded_donate"]
    assert all("peak~=null" in x for x in lines if not x.startswith("{"))
    first, *rest = _json(lines)
    assert first == {"device": "cpu"} and rest == ret
    for x in rest:
        assert set(x) == {"variant", "args_gib", "out_gib", "peak_gib",
                          "peak_note"}
        assert x["peak_gib"] is None and x["out_gib"] > x["args_gib"] > 0
    assert not torch.distributed.is_initialized()


def test_probe_sharded_mem_refuses_different_trees(monkeypatch):
    import vector_database_tpu_torch.parallel as par

    real = par.build_index_sharded

    def shifted(*a, **kw):
        index = real(*a, **kw)
        index.mid[0] += 1.0
        return index

    monkeypatch.setattr(par, "build_index_sharded", shifted)
    with pytest.raises(AssertionError, match="single and sharded mid"):
        _run(probe_sharded_mem, ["--n", "5000", "--d", "8"])
    assert not torch.distributed.is_initialized()
