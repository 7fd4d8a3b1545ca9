"""The plain reference against brute force, the recipe against its frozen
original, and the control failing the check."""

import numpy as np
import pytest
import torch

from vdb_bench import recipe
from vdb_bench.control import read
from vdb_bench.reference.knn import LowReference, distances, exact_knn
from vdb_bench.tests.cpu_sizes import CPU, REBUILD_SECONDS, overrides


def _brute(rows, queries, k, metric):
    x, q = rows.double().numpy(), queries.double().numpy()
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_knn_is_brute_force(metric):
    g = torch.Generator().manual_seed(3)
    rows = torch.randn(3000, 24, generator=g)
    rows[1500] = rows[20]  # an exact tie: the lower id first
    queries = torch.cat([torch.randn(40, 24, generator=g), rows[20:21]])
    ids, dist = exact_knn(rows, queries, 10, metric, chunk=700, extra=4)
    want_ids, want_d = _brute(rows, queries, 10, metric)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(dist.numpy(), want_d, rtol=1e-12, atol=1e-12)


def test_distances_refuse_bad_ids():
    rows = torch.arange(12.0).view(6, 2)
    q = torch.zeros(1, 2)
    d = distances(rows, q, torch.tensor([[1, 1, -1, 6, 2]]), "l2")
    assert d[0, 0] == 13.0 and d[0, 4] == 41.0  # rows (2, 3), (4, 5)
    assert torch.isinf(d[0, 1:4]).all()  # repeat, padding, past the end


def test_split_recipe_is_the_frozen_recipe():
    """``centres`` and ``draw`` on one generator give ``clustered``'s
    rows and queries bit for bit."""
    train, test = recipe.clustered(5000, 16, 300, 42, CPU)
    g = torch.Generator().manual_seed(42)
    cent = recipe.centres(g, 5000, 16)
    assert torch.equal(recipe.draw(g, cent, 5000), train)
    assert torch.equal(recipe.draw(g, cent, 300), test)


def test_styles():
    x = recipe.draw(torch.Generator().manual_seed(1),
                    recipe.centres(torch.Generator().manual_seed(0), 64, 8),
                    500)
    unit = recipe.styled(x.clone(), "unit")
    torch.testing.assert_close(unit.norm(dim=1), torch.ones(500))
    sift = recipe.styled(x.clone(), "sift")
    assert torch.equal(sift, sift.round()) and sift.min() >= 0
    assert sift.max() <= 255


def test_queries_differ_by_request_and_repeat_by_seed():
    cfg = {"n": 4000, "d": 8, "recipe": {"style": "unit"}}
    a, b = recipe.Recipe(cfg, 9, CPU), recipe.Recipe(cfg, 9, CPU)
    assert torch.equal(a.rows(), b.rows())
    assert torch.equal(a.queries(3, 50), b.queries(3, 50))
    assert not torch.equal(a.queries(3, 50), a.queries(4, 50))


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_low_reference_scores_its_own_values(fmt):
    """The control's distances are those of its rounded values."""
    g = torch.Generator().manual_seed(5)
    rows = torch.randn(2000, 16, generator=g)
    ctl = LowReference(rows, "l2", 5, fmt, chunk=300)
    ids, dist = ctl.query(rows[:7].numpy())
    assert ids.shape == (7, 5) and dist.shape == (7, 5)
    assert (ids[:, 0] == torch.arange(7)).float().mean() >= 5 / 7


@pytest.mark.parametrize("name", ["deep96.serve-full", "sift128.serve-full",
                                  "deep96.rebuild"])
@pytest.mark.parametrize("control", ["fp8-reference", "int8-reference"])
def test_control_fails_the_check(name, control):
    """The reference in a precision below bf16, in the program's place,
    comes out not correct; the program itself comes out correct."""
    secs = REBUILD_SECONDS if name.endswith("rebuild") else 0.0
    got = read(name, 17, control, secs, CPU, overrides(name))
    assert got["correct"] is False
    assert got["checks"]["dist_rel_err"]["value"] > \
        got["checks"]["dist_rel_err"]["limit"]
    sound = read(name, 17, "program", secs, CPU, overrides(name))
    assert sound["correct"] is True


@pytest.mark.parametrize("seed", [17, 18])
def test_program_int8_path_fails_the_check(seed):
    """The control, the program's own int8 path, loses nearest rows that
    bf16 keeps; on SIFT's integers it does so at any size (its deep
    readings need the cell's size: ``test_vdb_bench_card.py``)."""
    name = "sift128.serve-full"
    got = read(name, seed, "int8f", 0.0, CPU, overrides(name))
    assert got["correct"] is False
    checks = got["checks"]
    assert checks["nn_missed"]["value"] > checks["nn_missed"]["limit"]
    assert checks["recall_at_10"]["value"] < checks["recall_at_10"]["limit"]


def test_tree_check_counts_broken_promises():
    from vector_database_tpu_torch import build_index_fused

    from vdb_bench.reference.tree import tree_faults
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(30000, 12, generator=g)
    rows[:300] = rows[0]  # equal rows: nodes split by rank
    index = build_index_fused(rows, leaf_size=16, device="cpu")
    tree = {key: getattr(index, key) for key in (
        "orig_row", "dim", "mid", "low", "high", "leaf_start",
        "leaf_count")}
    assert tree_faults(rows, tree, 16) == 0
    assert tree_faults(rows, tree, 8) > 0  # leaves over the size
    moved = dict(tree, mid=tree["mid"].clone())
    moved["mid"][0] += 0.5
    assert tree_faults(rows, moved, 16) > 0
    dup = dict(tree, orig_row=tree["orig_row"].clone())
    dup["orig_row"][5] = dup["orig_row"][6]
    assert tree_faults(rows, dup, 16) == 2
    other = torch.randn(30000, 12, generator=g)
    assert tree_faults(other, tree, 16) > 0
