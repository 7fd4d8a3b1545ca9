"""The port's sharded global-tree build, and its host-loop build over a
mesh, against the JAX package's: the tests of ``test_torch_mesh_build_p2.py``
and ``_p4.py``, which set the rank count (the ``world`` fixture) and
import them.

The port side runs in spawned Gloo ranks (``torch_mesh_worker.py``, one
spawn per rank count, every case in it); the JAX side runs here on
``make_mesh(P)`` of conftest's 8 virtual devices. On integer-valued data
every f32 segment sum is exact in any order, so the node tables are
bitwise equal to JAX's and to the single-device fused build, and each
rank's leaf runs, rows and ``orig_row`` are JAX's shard ``p``. Searches
return JAX's rows with distances within 1e-5; ``knn_global`` ids may
differ only among rows that tie the k-th distance. The host-loop
``build_index(mesh=)`` returns the whole index on every rank: JAX's
``build_index(mesh=)`` index, field by field, and the single-device one
(rows over a 1-D mesh, and with ``dim_axis="model"`` over a 1 x 2 mesh at
two ranks, 2 x 2 at four).
"""

import functools

import numpy as np
import pytest
import torch

import torch_mesh_worker as w
from vector_database_tpu import build_index as jax_build_index
from vector_database_tpu.parallel import build_index_sharded as jax_build
from vector_database_tpu.parallel import knn_global as jax_knn
from vector_database_tpu.parallel import make_mesh, make_mesh_2d
from vector_database_tpu.parallel import search_global as jax_search
from vector_database_tpu.parallel import to_bsp as jax_to_bsp
from vector_database_tpu_torch import build_index, build_index_fused

torch.set_num_threads(2)

NODE = ("dim", "mid", "low", "high")
RUNS = ("leaf_start", "leaf_count", "vectors", "orig_row")
META = ("depth", "leaf_cap", "num_leaves")


@functools.lru_cache(maxsize=None)
def jax_side(name, world):
    rows, kw, q, radius, k = w.build_spec(name, world)
    idx = jax_build(rows, make_mesh(world), **kw)
    out = {f: np.asarray(getattr(idx, f)) for f in NODE + RUNS}
    out.update({f: getattr(idx, f) for f in META + ("n",)})
    out["bsp"] = {f: np.asarray(getattr(jax_to_bsp(idx), f))
                  for f in NODE + RUNS}
    r, d2, cnt, ov = jax_search(idx, q, radius)
    out["search"] = dict(rows=np.asarray(r), d2=np.asarray(d2),
                         count=np.asarray(cnt), overflow=np.asarray(ov))
    r, d2 = jax_knn(idx, q, k, radius)
    out["knn"] = dict(rows=np.asarray(r), d2=np.asarray(d2))
    out["count_global"] = np.asarray(idx.leaf_count_global())
    return out


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    j = jax_side("positional_uneven", world)
    inputs = {f"tree{world}": ({f: j[f] for f in NODE + RUNS},
                               {f: j[f] for f in META + ("n",)})}
    out = w.run_suite("build", world,
                      tmp_path_factory.mktemp(f"build{world}"), inputs)
    return world, out


def _case(ranks, name):
    world, out = ranks
    for p, res in enumerate(out):
        assert res["init_distributed"] is True
        assert "error" not in res[name], f"rank {p}:\n{res[name]['error']}"
    return world, [res[name] for res in out]


@pytest.mark.parametrize("name", w.BUILD_CASES)
def test_node_table_bitwise_equals_jax(ranks, name):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)
    for p, o in enumerate(outs):
        for f in NODE:
            np.testing.assert_array_equal(o["tree"][f], j[f],
                                          err_msg=f"rank {p} {f}")
        assert tuple(o["tree"][f] for f in META) == \
            tuple(j[f] for f in META)


@pytest.mark.parametrize("name", w.BUILD_CASES)
def test_rank_runs_rows_equal_jax_shard(ranks, name):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)
    n_loc = j["vectors"].shape[0] // world
    for p, o in enumerate(outs):
        for f in ("leaf_start", "leaf_count"):
            np.testing.assert_array_equal(o["tree"][f], j[f][p],
                                          err_msg=f"rank {p} {f}")
        for f in ("vectors", "orig_row"):
            np.testing.assert_array_equal(
                o["tree"][f], j[f][p * n_loc:(p + 1) * n_loc],
                err_msg=f"rank {p} {f}")


@pytest.mark.parametrize("name", w.BUILD_CASES)
def test_to_bsp_equals_jax(ranks, name):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)["bsp"]
    for p, o in enumerate(outs):
        for f in NODE + RUNS:
            np.testing.assert_array_equal(o["bsp"][f], j[f],
                                          err_msg=f"rank {p} {f}")


@pytest.mark.parametrize("name", [c for c in w.BUILD_CASES
                                  if c != "subsample4"])
def test_bitwise_equals_single_device_build(ranks, name):
    """The global tree is the fused build's tree (stats_subsample 1 both
    sides; a subsample of every shard differs from one of all rows)."""
    world, outs = _case(ranks, name)
    rows, kw, _, _, _ = w.build_spec(name, world)
    one = build_index_fused(rows, device="cpu", **kw)
    for f in NODE:
        np.testing.assert_array_equal(outs[0]["tree"][f],
                                      getattr(one, f).numpy(), err_msg=f)
    # the gathered tree holds every leaf's rows: to_bsp lays the leaves
    # out in node order, the build in the order its partitions left them
    g = outs[0]["bsp"]
    np.testing.assert_array_equal(g["leaf_count"], one.leaf_count.numpy())
    for m in np.nonzero(one.dim.numpy() == -1)[0]:
        lo, c = int(one.leaf_start[m]), int(one.leaf_count[m])
        glo = int(g["leaf_start"][m])
        np.testing.assert_array_equal(
            np.sort(g["orig_row"][glo:glo + c]),
            np.sort(one.orig_row.numpy()[lo:lo + c]), err_msg=f"leaf {m}")


@pytest.mark.parametrize("name", w.BUILD_CASES)
def test_search_global_equals_jax(ranks, name):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)["search"]
    for o in outs:
        s = o["search"]
        w.assert_same_matches(s["rows"], s["d2"], j["rows"], j["d2"], name)
        np.testing.assert_array_equal(s["count"], j["count"])
        np.testing.assert_array_equal(s["overflow"], j["overflow"])
        assert s["rows"].shape == j["rows"].shape


@pytest.mark.parametrize("name", w.BUILD_CASES)
def test_knn_global_equals_jax(ranks, name):
    world, outs = _case(ranks, name)
    j = jax_side(name, world)["knn"]
    for o in outs:
        w.assert_topk_equal(o["knn"]["rows"], o["knn"]["d2"], j["rows"],
                            j["d2"], what=name)
    for o in outs[1:]:  # the merge is replicated
        np.testing.assert_array_equal(o["knn"]["rows"], outs[0]["knn"]["rows"])


@pytest.mark.parametrize("name", ["positional_uneven", "n_lt_p"])
def test_leaf_count_global_equals_jax(ranks, name):
    world, outs = _case(ranks, name)
    for o in outs:
        np.testing.assert_array_equal(o["count_global"],
                                      jax_side(name, world)["count_global"])


def test_reader_asked_only_own_rows(ranks):
    world, outs = _case(ranks, "reader_asks_own_rows")
    n = w.build_spec("positional_uneven", world)[0].shape[0]
    n_loc = -(-n // world)
    j = jax_side("positional_uneven", world)
    for p, o in enumerate(outs):
        for lo, hi in o["asked"].tolist():
            if (lo, hi) == (0, 1):  # the dimensionality probe
                continue
            assert p * n_loc <= lo and hi <= min((p + 1) * n_loc, n), \
                (p, lo, hi)
        for f in NODE:
            np.testing.assert_array_equal(o["tree"][f], j[f])


def test_jax_built_tree_served_by_port(ranks):
    world, outs = _case(ranks, "from_jax_arrays")
    j = jax_side("positional_uneven", world)["knn"]
    for o in outs:
        w.assert_topk_equal(o["rows"], o["d2"], j["rows"], j["d2"])


HOST_FIELDS = NODE + RUNS


@pytest.mark.parametrize("name", w.HOST_CASES)
def test_host_loop_build_equals_jax_mesh_and_single_device(ranks, name):
    """Every rank's whole index is JAX's ``build_index(mesh=)`` index and
    the port's single-device host-loop tree (equal to JAX's single-device
    tree: ``test_torch_build_host.py``), bit for bit."""
    world, outs = _case(ranks, name)
    rows, kw, shape = w.host_spec(name, world)
    mesh = make_mesh(world) if shape is None else make_mesh_2d(*shape)
    jm = jax_build_index(rows, mesh=mesh, **kw)
    kw.pop("dim_axis", None)
    one = build_index(rows, device="cpu", **kw)
    for want in (jm, one):
        for p, o in enumerate(outs):
            for f in HOST_FIELDS:
                np.testing.assert_array_equal(
                    o["tree"][f], np.asarray(getattr(want, f)),
                    err_msg=f"rank {p} {f}")
            assert tuple(o["tree"][f] for f in META) == \
                tuple(getattr(want, f) for f in META)


def test_host_loop_dim_axis_uneven_raises_on_every_rank(ranks):
    world, outs = _case(ranks, "hl_dim_axis_uneven")
    for o in outs:
        assert o["raised"] and "dim_axis" in o["raised"]
