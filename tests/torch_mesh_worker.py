"""Rank side of the port's multi-rank CPU tests (``test_torch_mesh_*.py``).

A test module spawns P processes once (``run_suite``); each joins a Gloo
world of P ranks through a ``file://`` store, builds a ``cpu`` mesh, runs
every case of one suite in order and pickles each case's outputs as
numpy arrays, so that each case stays its own test. This module imports
torch and the port only, never JAX: a spawned rank loads neither JAX nor
the JAX package. The data of every case comes from numpy seeds through
the functions below, which the test modules call too, for the JAX side.
"""

from __future__ import annotations

import os
import pickle
import traceback
from datetime import timedelta

import numpy as np
import torch

# collectives that wait longer than this raise on every rank, so a rank
# that fails between two collectives fails its case instead of hanging
# the others
COLLECTIVE_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 150

SUITES: dict = {}


def case(suite):
    """Register ``fn(mesh, world, inputs) -> dict`` as a case of ``suite``."""
    def deco(fn):
        SUITES.setdefault(suite, []).append(fn)
        return fn
    return deco


def np_of(x):
    """A tensor as numpy (bf16 as its uint16 bits), anything else as is."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16)
    return x.detach().cpu().numpy()


def ints(seed, n, d, lo=-4, hi=4):
    """Integer-valued f32 rows: every f32 sum over them is exact in any
    order, so trees and scores are bitwise equal across packages."""
    return np.random.RandomState(seed).randint(lo, hi + 1, (n, d)).astype(
        np.float32)


def quarter_queries(seed, q, d, lo=-4, hi=4):
    """Queries on a grid of quarters: distances to integer rows stay exact
    and tie less often than on the integer grid."""
    rng = np.random.RandomState(seed)
    return (rng.randint(4 * lo, 4 * hi + 1, (q, d)) / 4.0).astype(np.float32)


# ---- the sharded build ----------------------------------------------------

def build_spec(name, world):
    """``(rows, build kwargs, queries, radius, k)`` of a build case."""
    if name == "positional_uneven":
        return ints(1, 203, 6), dict(leaf_size=2, stats_subsample=1), \
            quarter_queries(2, 9, 6), 2.5, 4
    if name == "mean_id":
        rows = np.repeat(ints(3, 30, 5, -3, 3), 5, axis=0)
        return rows, dict(leaf_size=2, tie_break="mean_id"), \
            quarter_queries(4, 8, 5, -3, 3), 2.0, 3
    if name == "duplicates_only":
        return np.full((37, 4), 2.0, np.float32), dict(leaf_size=1), \
            np.array([[2.0, 2, 2, 2], [2.0, 2, 2, 2.5]], np.float32), 1.0, 5
    if name == "n_lt_p":
        return ints(5, world - 1, 3), dict(), \
            quarter_queries(6, 3, 3), 20.0, 2
    if name == "subsample4":
        return ints(7, 1000, 8), dict(leaf_size=4, stats_subsample=4), \
            quarter_queries(8, 8, 8), 3.0, 5
    raise KeyError(name)


BUILD_CASES = ("positional_uneven", "mean_id", "duplicates_only", "n_lt_p",
               "subsample4")


def _tree_out(index):
    return {f: np_of(getattr(index, f)) for f in (
        "dim", "mid", "low", "high", "leaf_start", "leaf_count", "vectors",
        "orig_row")} | dict(depth=index.depth, leaf_cap=index.leaf_cap,
                            num_leaves=index.num_leaves)


def _build_case(name):
    def run(mesh, world, inputs):
        from vector_database_tpu_torch import parallel as par

        rows, kw, q, radius, k = build_spec(name, world)
        idx = par.build_index_sharded(rows, mesh, **kw)
        out = {"tree": _tree_out(idx), "bsp": _tree_out(par.to_bsp(idx))}
        r, d2, cnt, ov = par.search_global(idx, q, radius)
        out["search"] = dict(rows=np_of(r), d2=np_of(d2), count=np_of(cnt),
                             overflow=np_of(ov))
        r, d2 = par.knn_global(idx, q, k, radius)
        out["knn"] = dict(rows=np_of(r), d2=np_of(d2))
        out["count_global"] = np_of(idx.leaf_count_global())
        return out
    run.__name__ = name
    return run


for _name in BUILD_CASES:
    case("build")(_build_case(_name))


@case("build")
def reader_asks_own_rows(mesh, world, inputs):
    """``make_sharded_rows`` over a callable reader: the rows it asked
    for, and the build over them."""
    from vector_database_tpu_torch import parallel as par

    full, kw, _, _, _ = build_spec("positional_uneven", world)
    asked = []

    def reader(lo, hi):
        asked.append((lo, hi))
        return full[lo:hi]

    rows = par.make_sharded_rows(reader, mesh, n=full.shape[0])
    idx = par.build_index_sharded(rows, mesh, **kw)
    return dict(asked=np.array(asked), tree=_tree_out(idx))


@case("build")
def from_jax_arrays(mesh, world, inputs):
    """A JAX-built sharded tree served through the port."""
    from vector_database_tpu_torch import parallel as par

    arrays, meta = inputs[f"tree{world}"]
    idx = par.ShardedBSPIndex.from_numpy(arrays, meta, mesh)
    _, _, q, radius, k = build_spec("positional_uneven", world)
    r, d2 = par.knn_global(idx, q, k, radius)
    return dict(rows=np_of(r), d2=np_of(d2))


# ---- the host-loop build over a mesh --------------------------------------

def host_spec(name, world):
    """``(rows, build_index kwargs, 2-D mesh shape or None)`` of a
    host-loop case; no row count is a multiple of the rank count."""
    if name == "hl_leaf1":
        return ints(41, 29, 4), dict(leaf_size=1), None
    if name == "hl_leaf8_cap":
        return ints(42, 301, 5), dict(leaf_size=8, max_levels=3), None
    if name == "hl_duplicates":
        return np.repeat(ints(43, 5, 4, -2, 2), 6, axis=0)[:29], \
            dict(leaf_size=2), None
    if name == "hl_n_lt_p":
        return ints(44, world - 1, 3), dict(), None
    if name == "hl_dim_axis":  # 1 x 2 at two ranks, 2 x 2 at four
        return ints(45, 97, 4), dict(leaf_size=8, dim_axis="model"), \
            (world // 2, 2)
    raise KeyError(name)


HOST_CASES = ("hl_leaf1", "hl_leaf8_cap", "hl_duplicates", "hl_n_lt_p",
              "hl_dim_axis")


def _host_case(name):
    def run(mesh, world, inputs):
        from vector_database_tpu_torch import build_index
        from vector_database_tpu_torch import parallel as par

        rows, kw, shape = host_spec(name, world)
        if shape is not None:
            mesh = par.make_mesh_2d(*shape, device_type="cpu")
        return {"tree": _tree_out(build_index(rows, mesh=mesh, **kw))}
    run.__name__ = name
    return run


for _name in HOST_CASES:
    case("build")(_host_case(_name))


@case("build")
def hl_dim_axis_uneven(mesh, world, inputs):
    """7 dims over two column shards: every rank raises."""
    from vector_database_tpu_torch import build_index
    from vector_database_tpu_torch import parallel as par

    mesh2 = par.make_mesh_2d(world // 2, 2, device_type="cpu")
    try:
        build_index(ints(46, 50, 7), mesh=mesh2, dim_axis="model")
    except ValueError as e:
        return dict(raised=str(e))
    return dict(raised=None)


# ---- the sharded scan -----------------------------------------------------

# JAX's scan kernel loses the block id of a bucket whose best score is
# exactly 0: the id rides the low mantissa bits of a denormal, which XLA
# flushes to zero (``vector_database_tpu/ops/pallas_knn.py:192-193``), and
# the bucket then shortlists block 0's row. The port keeps the id. The
# integer cases below therefore never score exactly 0.

def odd_norms(rows, seed):
    """Integer rows with odd squared norms: against integer queries (2 q.v
    even) no l2 score ``|v|^2 - 2 q.v`` is 0."""
    rng = np.random.RandomState(seed)
    rows = rows.copy()
    even = (rows[:, :-1] ** 2).sum(axis=1) % 2 == 0
    rows[:, -1] = np.where(even, rng.choice([-3, -1, 1, 3], len(rows)),
                           rng.choice([-2, 0, 2], len(rows)))
    return rows


def half_dots(rows, q):
    """Integer rows with an odd last coordinate and queries with a last
    coordinate of +-0.5: every inner product is an integer plus a half,
    so no ip score ``-q.v`` is 0."""
    rows, q = rows.copy(), q.copy()
    rows[:, -1] = 2 * np.floor(rows[:, -1] / 2) + 1
    q[:, -1] = np.where(q[:, -1] >= 0, 0.5, -0.5)
    return rows, q


def scan_spec(name, world):
    """``(rows, pack kwargs, queries, serve kwargs)`` of a scan case."""
    if name == "l2":
        return odd_norms(ints(11, 1000, 16, -3, 3), 11), \
            dict(block=64, buckets=64), \
            ints(12, 32, 16, -3, 3), dict(k=5, q_tile=8)
    if name == "cosine":
        return ints(13, 600, 8), dict(block=64, buckets=64, metric="cosine"), \
            ints(14, 16, 8), dict(k=5, q_tile=8)
    if name == "ip_ragged":
        rows = ints(15, 101, 8)
        rows[95:] *= 8.0  # the highest dots in the padded last shard
        rows, q = half_dots(rows, ints(16, 4, 8))
        return rows, dict(block=32, buckets=32, metric="ip"), q, \
            dict(k=5, q_tile=8, oversample=32)
    if name == "orig_rows":
        rows = odd_norms(ints(17, 300, 8), 17)
        orig = (np.random.RandomState(18).permutation(300) * 3 + 7).astype(
            np.int32)
        return rows, dict(block=32, buckets=32, orig_rows=orig), \
            ints(19, 8, 8), dict(k=4, q_tile=8)
    if name == "n_lt_p":
        return odd_norms(ints(20, world - 1, 8), 20), \
            dict(block=32, buckets=32), \
            ints(21, 3, 8), dict(k=2, q_tile=8)
    if name == "clustered":
        rng = np.random.RandomState(22)
        centers = rng.randint(-12, 13, (16, 8))
        assign = np.sort(rng.randint(0, 16, 2400))  # leaf-major stand-in
        rows = odd_norms((centers[assign]
                          + rng.randint(-1, 2, (2400, 8))).astype(
            np.float32), 23)
        q = (centers[rng.randint(0, 16, 48)]
             + rng.randint(-1, 2, (48, 8))).astype(np.float32)
        return rows, dict(block=64, buckets=64), q, dict(k=5, q_tile=8)
    raise KeyError(name)


SCAN_CASES = ("l2", "cosine", "ip_ragged", "orig_rows", "n_lt_p",
              "clustered")


def _pack_out(db):
    return {f: np_of(getattr(db, f)) for f in (
        "vb", "vn", "vectors", "orig_row", "cent", "rad")} | dict(
        n_loc=db.n_loc, bits=db.bits)


def _scan_case(name):
    def run(mesh, world, inputs):
        from vector_database_tpu_torch import parallel as par

        rows, pkw, q, skw = scan_spec(name, world)
        db = par.pack_database_sharded(rows, mesh, **pkw)
        out = {"pack": _pack_out(db)}
        r, d = par.sharded_scan_knn(db, q, **skw)
        out["full"] = dict(rows=np_of(r), d2=np_of(d))
        nb = db.vb.shape[0]
        p = max(1, nb // 2)
        r, d = par.sharded_scan_knn(db, q, probes=p, **skw)
        out["static"] = dict(rows=np_of(r), d2=np_of(d), probes=p)
        r, d = par.sharded_scan_knn(db, q, probes=p, probes_max=nb, **skw)
        out["runtime"] = dict(rows=np_of(r), d2=np_of(d))
        r, d = par.sharded_scan_knn(db, q, probes=nb, **skw)
        out["probes_nb"] = dict(rows=np_of(r), d2=np_of(d))
        return out
    run.__name__ = name
    return run


for _name in SCAN_CASES:
    case("scan")(_scan_case(_name))


@case("scan")
def empty_input(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    try:
        par.pack_database_sharded(np.zeros((0, 8), np.float32), mesh)
    except ValueError as e:
        return dict(raised=str(e))
    return dict(raised=None)


@case("scan")
def calibrate(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    rows, pkw, q, skw = scan_spec("clustered", world)
    db = par.pack_database_sharded(rows, mesh, **pkw)
    return dict(probes=par.calibrate_probes_sharded(
        db, q, skw["k"], 0.9, q_tile=skw["q_tile"]))


@case("scan")
def server(mesh, world, inputs):
    """``PackedServer`` over the sharded pack: 40 queries in waves of 16,
    full and pruned (runtime probes)."""
    from vector_database_tpu_torch import PackedServer
    from vector_database_tpu_torch import parallel as par

    rows, pkw, q, skw = scan_spec("clustered", world)
    db = par.pack_database_sharded(rows, mesh, **pkw)
    srv = PackedServer(db, k=5, batch=16, q_tile=8)
    srv.warmup()
    r, d = srv.query(q[:40])
    pr = PackedServer(db, k=5, batch=16, q_tile=8, probes=2, probes_max=4)
    rp, dp = pr.query(q[:40])
    return dict(rows=np_of(r), d2=np_of(d), prows=np_of(rp), pd2=np_of(dp))


@case("scan")
def from_jax_pack(mesh, world, inputs):
    """A JAX-built sharded pack served through the port."""
    from vector_database_tpu_torch import parallel as par

    arrays, meta = inputs[f"pack{world}"]
    db = par.ShardedPackedDB.from_numpy(arrays, meta, mesh)
    _, _, q, skw = scan_spec("clustered", world)
    r, d = par.sharded_scan_knn(db, q, **skw)
    return dict(rows=np_of(r), d2=np_of(d))


# ---- the forest and the query-sharded search ------------------------------

def forest_data():
    """``(rows, queries, radius)`` of the forest cases."""
    return ints(31, 403, 4, -6, 6), quarter_queries(32, 7, 4, -6, 6), 3.0


@case("forest")
def forest(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    rows, q, radius = forest_data()
    fo = par.build_forest(rows, mesh, leaf_size=4)
    out = {}
    for name, r in (("wide", radius), ("narrow", 0.6)):
        rr, dd, ov = par.forest_knn(fo, q, 5, r)
        out[name] = dict(rows=np_of(rr), d2=np_of(dd), overflow=np_of(ov))
    out["widths"] = dict(m=fo.dim.shape[0], n=fo.vectors.shape[0],
                         depth=fo.depth, leaf_cap=fo.leaf_cap)
    return out


@case("forest")
def forest_from_jax(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    arrays, meta = inputs[f"forest{world}"]
    fo = par.ShardedForest.from_numpy(arrays, meta, mesh)
    _, q, radius = forest_data()
    rr, dd, _ = par.forest_knn(fo, q, 5, radius)
    return dict(rows=np_of(rr), d2=np_of(dd))


def _tree(rows):
    from vector_database_tpu_torch import build_index_fused

    return build_index_fused(rows, leaf_size=4, device="cpu")


@case("forest")
def query_sharded(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    rows, q, radius = forest_data()
    idx = _tree(rows)
    res = par.search_sharded(idx, q, radius, mesh)
    out = {f: np_of(getattr(res, f)) for f in (
        "rows", "sq_dists", "count", "candidates", "cand_rows", "overflow")}
    r, d = par.knn_sharded(idx, q, 5, radius, mesh)
    out["knn_rows"], out["knn_d2"] = np_of(r), np_of(d)
    return out


@case("forest")
def agreed_growth(mesh, world, inputs):
    """Queries whose leaf buffers overflow on some ranks only: every rank
    must grow together (else the gather's widths differ)."""
    from vector_database_tpu_torch import parallel as par

    rows, _, _ = forest_data()
    idx = _tree(rows)
    q = np.zeros((2 * world, 4), np.float32)
    q[world:] = 100.0  # far from every row: no leaf reached
    res = par.search_sharded(idx, q, 4.0, mesh, max_leaves=2)
    return dict(rows=np_of(res.rows), count=np_of(res.count),
                overflow=np_of(res.overflow))


# ---- the multi-process twin -----------------------------------------------

def multi_data():
    """``(rows, queries, radius)``: the radius reaches every query's third
    neighbour, so radius-bounded 3-NN is the exact 3-NN."""
    full = ints(3, 203, 6)
    q = full[:4] + 0.25
    d2 = ((q[:, None, :] - full[None]) ** 2).sum(-1)
    return full, q, float(np.sqrt(np.sort(d2, axis=1)[:, 2].max())) + 0.1


@case("multi")
def world_build(mesh, world, inputs):
    """One tree over every rank, the reader asked only for own rows."""
    from vector_database_tpu_torch import parallel as par

    full, q, radius = multi_data()
    asked = []

    def reader(lo, hi):
        asked.append((lo, hi))
        return full[lo:hi]

    rows = par.make_sharded_rows(reader, mesh, n=full.shape[0])
    idx = par.build_index_sharded(rows, mesh, leaf_size=2,
                                  stats_subsample=1)
    r, d2 = par.knn_global(idx, q, 3, radius)
    return dict(asked=np.array(asked), tree=_tree_out(idx), rows=np_of(r),
                d2=np_of(d2))


@case("multi")
def multislice(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    full, q, radius = multi_data()
    asked = []

    def reader(lo, hi):
        asked.append((lo, hi))
        return full[lo:hi]

    groups = par.slice_groups(n_slices=2)
    meshes = par.make_slice_meshes(2, device_type="cpu")
    ms = par.build_index_multislice(reader, n=full.shape[0], n_slices=2,
                                    leaf_size=2, device_type="cpu")
    mine = [s for s, sl in enumerate(ms.slices) if sl is not None]
    kr, kd = par.knn_multislice(ms, q, 3, radius)
    sr, sd, cnt, ov = par.search_multislice(ms, q, 1.5)
    return dict(groups=np.array(groups),
                meshes=[None if m is None else m.size(0) for m in meshes],
                mine=mine, offsets=ms.offsets, asked=np.array(asked),
                tree=_tree_out(ms.slices[mine[0]]),
                knn_rows=np_of(kr), knn_d2=np_of(kd), search_rows=np_of(sr),
                search_d2=np_of(sd), count=np_of(cnt), overflow=np_of(ov))


@case("multi")
def scan_across_ranks(mesh, world, inputs):
    """The sharded scan's merge across every rank: full, and pruned to one
    of each rank's two local blocks (self-queries find themselves)."""
    from vector_database_tpu_torch import parallel as par

    full, q, radius = multi_data()
    db = par.pack_database_sharded(full, mesh, block=32, buckets=32)
    r, d = par.sharded_scan_knn(db, q, k=3, q_tile=8)
    pr, pd = par.sharded_scan_knn(db, full[:8], k=1, q_tile=8, probes=1)
    return dict(nb=db.vb.shape[0], rows=np_of(r), d2=np_of(d),
                prows=np_of(pr), pd2=np_of(pd))


@case("multi")
def slice_errors(mesh, world, inputs):
    from vector_database_tpu_torch import parallel as par

    out = {}
    try:
        par.slice_groups(n_slices=3)
    except ValueError as e:
        out["three"] = str(e)
    try:
        par.build_index_multislice(np.ones((1, 3), np.float32), n_slices=2,
                                   device_type="cpu")
    except ValueError as e:
        out["too_few"] = str(e)
    out["again"] = par.init_distributed(device_type="cpu")
    return out


# ---- process plumbing -----------------------------------------------------

def _rank_main(rank, world, init_file, out_dir, suite, inputs_path):
    import torch.distributed as dist

    from vector_database_tpu_torch import parallel as par

    torch.set_num_threads(1)
    inputs = {}
    if inputs_path is not None:
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
    ok = par.init_distributed(
        num_processes=world, process_id=rank, device_type="cpu",
        init_method=f"file://{init_file}",
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mesh = par.make_mesh(device_type="cpu")
    results = {"init_distributed": ok}
    for fn in SUITES[suite]:
        try:
            results[fn.__name__] = fn(mesh, world, inputs)
        except Exception:  # noqa: BLE001 - reported as that case's failure
            results[fn.__name__] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def run_suite(suite, world, tmp_dir, inputs=None):
    """Run every case of ``suite`` on ``world`` spawned Gloo ranks: a list
    of each rank's ``{case: outputs}`` (a case that raised holds
    ``{"error": traceback}``). Raises if a rank dies or outlives
    ``JOIN_TIMEOUT_S``."""
    import multiprocessing as mp

    tmp_dir = str(tmp_dir)
    inputs_path = None
    if inputs is not None:
        inputs_path = os.path.join(tmp_dir, "inputs.pkl")
        with open(inputs_path, "wb") as f:
            pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, os.path.join(tmp_dir, "store"), tmp_dir, suite,
        inputs_path)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if alive:
        raise RuntimeError(f"{len(alive)} of {world} ranks hung")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- checks shared by the test modules (numpy only) -----------------------

def assert_topk_equal(got_rows, got_d, want_rows, want_d, *, what="",
                      largest=False):
    """Two top-k answers agree: the scores equal within 1e-5 (relative
    and absolute), and the ids equal as sets wherever a score is strictly
    inside the k-th; ids that tie the k-th score may differ (the packages
    visit candidates in other orders). ``largest``: scores are dots,
    highest first."""
    got_rows, want_rows = np.asarray(got_rows), np.asarray(want_rows)
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5,
                               err_msg=what)
    key_g = -got_d if largest else got_d
    key_w = -want_d if largest else want_d
    for i in range(want_rows.shape[0]):
        fin = np.isfinite(key_w[i])
        np.testing.assert_array_equal(np.isfinite(key_g[i]), fin,
                                      err_msg=what)
        np.testing.assert_array_equal(got_rows[i][~fin], -1, err_msg=what)
        if not fin.any():
            continue
        kth = key_w[i][fin].max()
        tol = 1e-5 * (1 + abs(kth))
        inner_w = set(want_rows[i][fin & (key_w[i] < kth - tol)].tolist())
        inner_g = set(got_rows[i][np.isfinite(key_g[i])
                                  & (key_g[i] < kth - tol)].tolist())
        assert inner_g == inner_w, f"{what} query {i}: {inner_g} != {inner_w}"
        assert len(set(got_rows[i][fin].tolist())) == int(fin.sum()), what


def assert_same_matches(got_rows, got_d2, want_rows, want_d2, what=""):
    """Two radius searches give the same (row, distance) pairs per query,
    in any order and at any padding width."""
    for i in range(np.asarray(want_rows).shape[0]):
        g = {int(r): float(d) for r, d in zip(got_rows[i], got_d2[i])
             if r >= 0}
        w = {int(r): float(d) for r, d in zip(want_rows[i], want_d2[i])
             if r >= 0}
        assert g.keys() == w.keys(), f"{what} query {i}"
        for r in w:
            assert abs(g[r] - w[r]) <= 1e-5 * (1 + abs(w[r])), (what, i, r)
