"""BSPIndex heap-row export and import of vector_database_tpu_torch against
the JAX package's (``heap_rows``, ``from_heap_rows``,
``from_reference_csv``).

On integer-valued data both packages' fused builds give the same tree, so
their exports are equal row for row; an export of either imports into the
other, and the imported trees answer radius queries as the originals do.
"""

import numpy as np
import pytest
import torch

from vector_database_tpu import build_index_fused as jax_build
from vector_database_tpu import search as jax_search
from vector_database_tpu.models.bsp import BSPIndex as JaxBSPIndex
from vector_database_tpu_torch import BSPIndex, build_index_fused, search
from vector_database_tpu_torch.utils import datasets

torch.set_num_threads(2)


def _ints(seed, n, d, span=8):
    rng = np.random.default_rng(seed)
    return rng.integers(-span, span + 1, (n, d)).astype(np.float32)


def _matches(res, n_queries):
    return [set(res.match_rows(i).tolist()) for i in range(n_queries)]


@pytest.mark.parametrize("dup", [False, True])
def test_heap_rows_equal_jax(dup):
    """Integer rows (with duplicates: id-partitioned dual nodes)."""
    vecs = _ints(3, 60, 4)
    if dup:
        vecs = np.concatenate([vecs, vecs[:16]])
    t = build_index_fused(vecs, leaf_size=1, device="cpu")
    j = jax_build(vecs, leaf_size=1)
    rows = list(t.heap_rows())
    assert rows == list(j.heap_rows())
    assert any(r[1] == -2 for r in rows) or not dup
    heap_ids = [r[0] for r in rows]
    assert len(set(heap_ids)) == len(heap_ids)
    assert sorted(r[3] for r in rows if r[1] == -1) == list(range(len(vecs)))


def test_heap_import_round_trip_both_ways():
    base = datasets.random_uniform(48, 4, seed=9)
    vecs = np.concatenate([base, base[:16]])  # duplicates -> dual nodes
    t = build_index_fused(vecs, leaf_size=1, device="cpu")
    rows = list(t.heap_rows())
    imp = BSPIndex.from_heap_rows(rows, vecs, device="cpu")
    assert list(imp.heap_rows()) == rows
    assert imp.depth == t.depth
    assert imp.leaf_cap == 1 and imp.num_leaves == t.num_leaves
    jimp = JaxBSPIndex.from_heap_rows(rows, vecs)
    assert list(jimp.heap_rows()) == rows
    # the JAX tree's export imports into the port
    jrows = list(jax_build(vecs, leaf_size=1).heap_rows())
    assert list(BSPIndex.from_heap_rows(jrows, torch.from_numpy(vecs))
                .heap_rows()) == jrows
    q = vecs[:6] + 0.01
    want = _matches(search(t, q, 0.5), 6)
    assert _matches(search(imp, q, 0.5), 6) == want
    assert _matches(jax_search(jimp, q, 0.5), 6) == want


def test_reference_csv_import(tmp_path):
    vecs = datasets.random_uniform(40, 3, seed=17)
    rows = list(jax_build(vecs, leaf_size=1).heap_rows())
    path = tmp_path / "index.csv"
    with open(path, "w") as f:
        f.write("RangeID,Dimension,Mid,ID\n")
        for heap, dim, mid, vid in rows:
            f.write(f"{heap},{dim},{mid},{vid}\n")
    imp = BSPIndex.from_reference_csv(str(path), vecs, device="cpu")
    assert list(imp.heap_rows()) == rows
    assert list(JaxBSPIndex.from_reference_csv(str(path), vecs)
                .heap_rows()) == rows


def test_heap_import_sql_null_form():
    rows = [
        (0, None, None, None),       # dual root (NULL dim, no id)
        (1, "NULL", "NULL", "0"),    # leaf -> vector 0
        (2, "", "", 1),              # leaf -> vector 1
    ]
    vecs = np.array([[0.0], [1.0]], np.float32)
    imp = BSPIndex.from_heap_rows(rows, vecs, device="cpu")
    assert imp.dim.tolist() == [-2, -1, -1]
    res = search(imp, np.array([[0.5]], np.float32), 2.0)
    assert set(res.match_rows(0).tolist()) == {0, 1}


@pytest.mark.parametrize("rows,match", [
    ([(1, -1, 0.0, 0)], "root"),
    ([(0, 0, 0.5, -1), (1, -1, 0.0, 0)], "missing a child"),
    ([(0, -1, 0.0, 0)], "leaves"),
    ([(0, 0, 0.5, -1), (1, -1, 0.0, 0), (2, -1, 0.0, 0)], "duplicate"),
    ([(0, 5, 0.5, -1), (1, -1, 0.0, 0), (2, -1, 0.0, 1)], "split dimension"),
    ([(0, -3, 0.5, -1), (1, -1, 0.0, 0), (2, -1, 0.0, 1)],
     "split dimension"),
    ([(0, 0, 0.5, -1), (1, -1, 0.0, 0), (2, -1, 0.0, 1), (0, 0, 0.7, -1)],
     "duplicate range id"),
])
def test_heap_import_rejects_malformed(rows, match):
    vecs = np.zeros((2, 1), np.float32)
    with pytest.raises(ValueError, match=match):
        BSPIndex.from_heap_rows(rows, vecs, device="cpu")
    with pytest.raises(ValueError, match=match):
        JaxBSPIndex.from_heap_rows(rows, vecs)


def test_heap_import_nonpositional_ids():
    """ids= remaps exported vector ids to row positions."""
    vecs = datasets.random_uniform(24, 3, seed=33)
    index = build_index_fused(vecs, leaf_size=1, device="cpu")
    rows = list(index.heap_rows())
    perm = np.random.default_rng(7).permutation(24)
    shuffled = vecs[perm]  # row perm[i] stored under external id 100+perm[i]
    ids = 100 + perm.astype(np.int64)
    ext_rows = [(h, d, m, (100 + v if d == -1 else v)) for h, d, m, v in rows]
    imp = BSPIndex.from_heap_rows(ext_rows, shuffled, ids=ids, device="cpu")
    jimp = JaxBSPIndex.from_heap_rows(ext_rows, shuffled, ids=ids)
    q = vecs[:5] + 0.01
    want = _matches(search(index, q, 0.4), 5)
    got = [{int(perm[r]) for r in s} for s in _matches(search(imp, q, 0.4), 5)]
    jgot = [{int(perm[r]) for r in s}
            for s in _matches(jax_search(jimp, q, 0.4), 5)]
    assert got == want == jgot
    assert sum(len(s) for s in got) > 0
    with pytest.raises(ValueError, match="not present in ids"):
        BSPIndex.from_heap_rows(
            [(h, d, m, (999 if d == -1 else v)) for h, d, m, v in rows],
            shuffled, ids=ids, device="cpu")
    with pytest.raises(ValueError, match="duplicate vector id in ids"):
        BSPIndex.from_heap_rows(ext_rows, shuffled, ids=np.zeros(24, np.int64),
                                device="cpu")
    with pytest.raises(ValueError, match="shape"):
        BSPIndex.from_heap_rows(ext_rows, shuffled, ids=ids[:5], device="cpu")


def test_ties_high_and_device_follow_the_arguments():
    vecs = torch.tensor([[0.0], [1.0]])
    rows = [(0, 0, 0.5, -1), (1, -1, 0.0, 0), (2, -1, 0.0, 1)]
    imp = BSPIndex.from_heap_rows(rows, vecs, ties_high=True)
    assert imp.ties_high and imp.device.type == "cpu"
