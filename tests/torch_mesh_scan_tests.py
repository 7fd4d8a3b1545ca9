"""The port's sharded packed scan against the JAX package's: the tests of
``test_torch_mesh_scan_p2.py`` and ``_p4.py``, which set the rank count
(the ``world`` fixture) and import them.

The port side runs in spawned Gloo ranks (``torch_mesh_worker.py``, one
spawn, every case in it), the kernel's plain version on the CPU; the JAX
side runs here on ``make_mesh(P)`` of conftest's 8 virtual devices, its
Pallas kernel in interpret mode. On integer-valued rows and queries the
bf16 blocks, the norm rows and every score are exact, so each rank's
blocks equal JAX's shard ``p`` bitwise and the answers are JAX's: ids
equal (up to rows that tie the k-th distance), distances within 1e-5.
The pruning summaries are means, f32 sums in another order: within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import torch_mesh_worker as w
from vector_database_tpu.parallel import calibrate_probes_sharded as jax_cal
from vector_database_tpu.parallel import make_mesh
from vector_database_tpu.parallel import pack_database_sharded as jax_pack
from vector_database_tpu.parallel import sharded_scan_knn as jax_scan
from vector_database_tpu.serving import PackedServer as JaxServer

torch.set_num_threads(2)

# the cases whose pruned scans are held against JAX's too (each JAX scan
# is a shard_map program of its own, compiled here on the CPU)
PROBED = ("l2", "clustered")
PACK = ("vb", "vn", "vectors", "orig_row", "cent", "rad")


@functools.lru_cache(maxsize=None)
def jax_pack_of(name, world):
    rows, pkw, _, _ = w.scan_spec(name, world)
    return jax_pack(rows, make_mesh(world), **pkw)


@functools.lru_cache(maxsize=None)
def jax_side(name, world):
    _, _, q, skw = w.scan_spec(name, world)
    db = jax_pack_of(name, world)
    out = {"pack": {f: np.asarray(getattr(db, f)) for f in PACK}}
    r, d = jax_scan(db, q, **skw)
    out["full"] = dict(rows=np.asarray(r), d2=np.asarray(d))
    if name in PROBED:
        nb = db.vb.shape[1]
        p = max(1, nb // 2)
        r, d = jax_scan(db, q, probes=p, **skw)
        out["static"] = dict(rows=np.asarray(r), d2=np.asarray(d), probes=p)
        r, d = jax_scan(db, q, probes=p, probes_max=nb, **skw)
        out["runtime"] = dict(rows=np.asarray(r), d2=np.asarray(d))
    return out


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    db = jax_pack_of("clustered", world)
    meta = dict(n=db.n, n_loc=db.n_loc, block=db.block, m=db.m,
                bits=db.bits, metric=db.metric)
    inputs = {f"pack{world}": ({f: np.asarray(getattr(db, f))
                                for f in PACK}, meta)}
    out = w.run_suite("scan", world,
                      tmp_path_factory.mktemp(f"scan{world}"), inputs)
    return world, out


def _case(ranks, name):
    world, out = ranks
    for p, res in enumerate(out):
        assert "error" not in res[name], f"rank {p}:\n{res[name]['error']}"
    return world, [res[name] for res in out]


def _check(got, want, name, metric):
    w.assert_topk_equal(got["rows"], got["d2"], want["rows"], want["d2"],
                        what=name, largest=metric == "ip")


@pytest.mark.parametrize("name", w.SCAN_CASES)
def test_rank_pack_equals_jax_shard(ranks, name):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)["pack"]
    for p, o in enumerate(outs):
        got = o["pack"]
        np.testing.assert_array_equal(got["vb"].view(np.uint16),
                                      j["vb"][p].view(np.uint16))
        np.testing.assert_array_equal(got["vn"], j["vn"][p])
        np.testing.assert_array_equal(got["orig_row"], j["orig_row"][p])
        np.testing.assert_allclose(got["vectors"], j["vectors"][p],
                                   rtol=1e-6, atol=1e-6)
        for f in ("cent", "rad"):
            np.testing.assert_allclose(got[f], j[f][p], rtol=1e-5,
                                       atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", w.SCAN_CASES)
def test_full_scan_equals_jax(ranks, name):
    world, outs = _case(ranks, name)
    metric = w.scan_spec(name, world)[1].get("metric", "l2")
    j = jax_side(name, world)["full"]
    for o in outs:
        _check(o["full"], j, name, metric)
    for o in outs[1:]:  # the merge is replicated
        np.testing.assert_array_equal(o["full"]["rows"],
                                      outs[0]["full"]["rows"])


@pytest.mark.parametrize("name", PROBED)
@pytest.mark.parametrize("mode", ["static", "runtime"])
def test_pruned_scan_equals_jax(ranks, name, mode):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)
    assert outs[0]["static"]["probes"] == j["static"]["probes"]
    for o in outs:
        _check(o[mode], j[mode], f"{name} {mode}", "l2")


@pytest.mark.parametrize("name", w.SCAN_CASES)
def test_runtime_probes_equal_static_and_all_blocks_full(ranks, name):
    """Within the port, bit for bit: runtime probes equal static probes,
    and probes = the rank's block count is the full scan."""
    _, outs = _case(ranks, name)
    for o in outs:
        for f in ("rows", "d2"):
            np.testing.assert_array_equal(o["runtime"][f], o["static"][f])
            np.testing.assert_array_equal(o["probes_nb"][f], o["full"][f])


def test_empty_input_raises(ranks):
    _, outs = _case(ranks, "empty_input")
    for o in outs:
        assert o["raised"] is not None and "empty" in o["raised"]


def test_calibrate_probes_sharded_equals_jax(ranks):
    world, outs = _case(ranks, "calibrate")
    _, _, q, skw = w.scan_spec("clustered", world)
    want = jax_cal(jax_pack_of("clustered", world), q, skw["k"], 0.9,
                   q_tile=skw["q_tile"])
    assert [o["probes"] for o in outs] == [want] * world


def test_packed_server_over_sharded_pack_equals_jax(ranks):
    world, outs = _case(ranks, "server")
    _, _, q, _ = w.scan_spec("clustered", world)
    db = jax_pack_of("clustered", world)
    r, d = JaxServer(db, k=5, batch=16, q_tile=8).query(q[:40])
    rp, dp = JaxServer(db, k=5, batch=16, q_tile=8, probes=2,
                       probes_max=4).query(q[:40])
    for o in outs:
        w.assert_topk_equal(o["rows"], o["d2"], r, d, what="full")
        w.assert_topk_equal(o["prows"], o["pd2"], rp, dp, what="pruned")


def test_jax_built_pack_served_by_port(ranks):
    world, outs = _case(ranks, "from_jax_pack")
    j = jax_side("clustered", world)["full"]
    for o in outs:
        _check(o, j, "from_numpy", "l2")
