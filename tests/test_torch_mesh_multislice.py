"""The Gloo twin of ``test_multiprocess.py``: 4 spawned ranks, two virtual
slices of two, driving the port's multi-process paths.

Each rank asks its reader only for its own rows (plus the one-row probe);
the tree over all four ranks and each slice's tree are bit-equal to the
single-device fused build of their rows (integer-valued data); the
cross-slice ``knn_multislice``/``search_multislice`` equal the exact
oracle and the JAX package's on every rank; the sharded scan's merge
crosses every rank, pruned included. ``init_distributed`` is a no-op
here, in the test process, which never starts a process group.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_worker as w
from vector_database_tpu.parallel import build_index_multislice as jax_ms
from vector_database_tpu.parallel import knn_multislice as jax_ms_knn
from vector_database_tpu.parallel import search_multislice as jax_ms_search
from vector_database_tpu_torch import build_index_fused
from vector_database_tpu_torch.parallel import init_distributed

torch.set_num_threads(2)

WORLD = 4
NODE = ("dim", "mid", "low", "high")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_suite("multi", WORLD, tmp_path_factory.mktemp("multi"))


def _case(ranks, name):
    for p, res in enumerate(ranks):
        assert res["init_distributed"] is True
        assert "error" not in res[name], f"rank {p}:\n{res[name]['error']}"
    return [res[name] for res in ranks]


def _oracle(rows, q, k):
    d2 = ((q[:, None, :] - rows[None]) ** 2).sum(-1)
    o = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return o, np.take_along_axis(d2, o, 1)


def _spans(n, parts):
    n_loc = -(-n // parts)
    return [(p * n_loc, min((p + 1) * n_loc, n)) for p in range(parts)]


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(device_type="cpu") is False
    assert not dist.is_initialized()


def test_world_build_reads_own_rows_and_equals_fused(ranks):
    outs = _case(ranks, "world_build")
    full, q, radius = w.multi_data()
    one = build_index_fused(full, leaf_size=2, stats_subsample=1,
                            device="cpu")
    for p, o in enumerate(outs):
        lo, hi = _spans(full.shape[0], WORLD)[p]
        for a, b in o["asked"].tolist():
            assert (a, b) == (0, 1) or (lo <= a and b <= hi), (p, a, b)
        for f in NODE:
            np.testing.assert_array_equal(o["tree"][f],
                                          getattr(one, f).numpy(), err_msg=f)
        _, d2 = _oracle(full, q, 3)
        np.testing.assert_allclose(o["d2"], d2, rtol=1e-5, atol=1e-5)


def test_slices_partition_the_ranks(ranks):
    outs = _case(ranks, "multislice")
    for p, o in enumerate(outs):
        np.testing.assert_array_equal(o["groups"], [[0, 1], [2, 3]])
        assert o["mine"] == [p // 2]
        assert o["meshes"] == [2 if s == p // 2 else None for s in range(2)]


def test_multislice_reads_own_rows_and_slice_trees_equal_fused(ranks):
    outs = _case(ranks, "multislice")
    full, _, _ = w.multi_data()
    bounds = np.linspace(0, full.shape[0], 3).astype(np.int64).tolist()
    for p, o in enumerate(outs):
        assert o["offsets"] == bounds[:2]
        s, lo, hi = p // 2, bounds[p // 2], bounds[p // 2 + 1]
        a_lo, a_hi = _spans(hi - lo, 2)[p % 2]
        for a, b in o["asked"].tolist():
            assert (a, b) == (lo, lo + 1) or \
                (lo + a_lo <= a and b <= lo + a_hi), (p, a, b)
        one = build_index_fused(full[lo:hi], leaf_size=2, device="cpu")
        for f in NODE:
            np.testing.assert_array_equal(o["tree"][f],
                                          getattr(one, f).numpy(),
                                          err_msg=f"slice {s} {f}")


def test_knn_multislice_equals_oracle_and_jax(ranks):
    outs = _case(ranks, "multislice")
    full, q, radius = w.multi_data()
    ms = jax_ms(full, n_slices=2, leaf_size=2)
    jr, jd = jax_ms_knn(ms, q, 3, radius)
    orow, od2 = _oracle(full, q, 3)
    for o in outs:
        w.assert_topk_equal(o["knn_rows"], o["knn_d2"], jr, jd, what="jax")
        w.assert_topk_equal(o["knn_rows"], o["knn_d2"], orow, od2,
                            what="oracle")
        np.testing.assert_array_equal(o["knn_rows"], outs[0]["knn_rows"])


def test_search_multislice_equals_oracle_and_jax(ranks):
    outs = _case(ranks, "multislice")
    full, q, radius = w.multi_data()
    ms = jax_ms(full, n_slices=2, leaf_size=2)
    jr, jd, jc, jov = jax_ms_search(ms, q, 1.5)
    d2 = ((q[:, None, :] - full[None]) ** 2).sum(-1)
    for o in outs:
        w.assert_same_matches(o["search_rows"], o["search_d2"], jr, jd)
        np.testing.assert_array_equal(o["count"], jc)
        np.testing.assert_array_equal(o["overflow"], jov)
        for i in range(q.shape[0]):
            got = set(o["search_rows"][i].tolist()) - {-1}
            assert got == set(np.nonzero(d2[i] <= 1.5 ** 2)[0].tolist())


def test_sharded_scan_merges_across_every_rank(ranks):
    outs = _case(ranks, "scan_across_ranks")
    full, q, radius = w.multi_data()
    _, od2 = _oracle(full, q, 3)
    for o in outs:
        assert o["nb"] == 2  # probes=1 is genuinely pruned
        np.testing.assert_allclose(o["d2"], od2, rtol=1e-5, atol=1e-5)
        # every query's best block is forced into its tile's list: the
        # self-queries find themselves
        np.testing.assert_allclose(o["pd2"][:, 0], 0.0, atol=1e-6)
        np.testing.assert_array_equal(o["prows"][:, 0], np.arange(8))


def test_slice_errors_and_repeat_init(ranks):
    outs = _case(ranks, "slice_errors")
    for o in outs:
        assert "do not split into 3 slices" in o["three"]
        assert "need at least 2 rows" in o["too_few"]
        assert o["again"] is True
