"""Entry points of the port (the twin of ``__graft_entry__.py``): a
single-device forward step and a multi-device dry run.

    python -c "from vector_database_tpu_torch.entry import entry; \\
        f, (q,) = entry('cpu'); print(f(q)[1][:2])"
    python -c "from vector_database_tpu_torch.entry import \\
        dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import os
import traceback
from datetime import timedelta

import numpy as np
import torch

# JAX's forward: 4096 x 32 uniform rows, leaf 8; the expected nearest
# distance is ~3, so this radius keeps the walk selective and the top-k
# populated
RADIUS, K, MAX_LEAVES = 3.2, 10, 256
# a collective that waits longer raises on every rank; a rank still alive
# after the join timeout is killed and the dry run fails
COLLECTIVE_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


def entry(device=None):
    """Forward step on the flagship model: batched k-NN (lockstep tree
    descent, exact rerank, stable top-k) over a built BSP index, on
    ``device`` (default: the card).

    Returns ``(forward, (queries,))``; ``forward(queries)`` gives ``(rows
    [Q, k], sq_dists [Q, k])``, the lower candidate first on equal
    distances (as ``lax.top_k``), -1 / +inf where a query has fewer than
    k rows within the radius. The walk starts with JAX's 256-leaf buffer
    and doubles it while a query overflows, as ``search`` does: JAX's
    forward keeps its fixed buffer, which every query of this batch
    overflows, and so returns the best of the leaves its walk kept."""
    from vector_database_tpu_torch import build_index_fused, knn
    from vector_database_tpu_torch.utils import datasets
    from vector_database_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    index = build_index_fused(datasets.random_uniform(4096, 32, seed=0),
                              leaf_size=8, device=dev)

    def forward(queries):
        return knn(index, queries, K, RADIUS, max_leaves=MAX_LEAVES)

    queries = torch.as_tensor(datasets.random_uniform(256, 32, seed=1),
                              device=dev)
    return forward, (queries,)


def dryrun_multichip(n_devices: int) -> None:
    """The sharded paths over an ``n_devices`` mesh at tiny shapes, each
    against the exact oracle: the host-loop build over row shards (and,
    for an even ``n_devices >= 4``, over a 2-D mesh with the vector dims
    sharded), the query-sharded search, the forest, the sharded scan (full,
    static and runtime pruned) and ``PackedServer`` over it, the sharded
    fused build against the single-device one, ``search_global``/
    ``knn_global`` and the two-slice index.

    It spawns ``n_devices`` Gloo ranks on the host (``device_type="cpu"``:
    one card cannot hold two NCCL ranks), joined through a ``file://``
    store in a temporary directory. A rank that fails, or that is still
    alive after ``JOIN_TIMEOUT_S``, raises ``RuntimeError`` here, with the
    failing ranks' tracebacks."""
    import multiprocessing as mp
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_dryrun_rank, args=(
            r, n_devices, os.path.join(tmp, "store"), tmp))
            for r in range(n_devices)]
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
        errors = []
        for r in range(n_devices):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
    if alive:
        raise RuntimeError(f"{len(alive)} of {n_devices} ranks hung\n"
                           + "\n".join(errors))
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"dry run failed: exit codes {codes}\n"
                           + "\n".join(errors))


def _dryrun_rank(rank, world, store, out_dir):
    """One rank of ``dryrun_multichip``: join the world, run the body; a
    failure leaves its traceback in ``out_dir`` and a non-zero exit."""
    import torch.distributed as dist

    from vector_database_tpu_torch import parallel as par

    torch.set_num_threads(1)
    try:
        par.init_distributed(
            num_processes=world, process_id=rank, device_type="cpu",
            init_method=f"file://{store}",
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        _dryrun_body(world)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _same_sets(rows, want, what):
    """Each query's non-negative ``rows`` form the set ``want[query]``."""
    for qi, w in enumerate(want):
        got = set(r for r in rows[qi].tolist() if r >= 0)
        if got != w:
            raise AssertionError(f"{what} mismatch on query {qi}")


def _ball_sets(vectors, queries, radius):
    from vector_database_tpu_torch import exact_ball

    ball = exact_ball(vectors, queries, radius).numpy()
    return [set(np.nonzero(b)[0].tolist()) for b in ball]


def _dryrun_body(n_devices: int) -> None:
    """``__graft_entry__.dryrun_multichip``'s checks on this rank."""
    from vector_database_tpu_torch import (
        PackedServer,
        build_index,
        build_index_fused,
        exact_knn,
    )
    from vector_database_tpu_torch import parallel as par
    from vector_database_tpu_torch.utils import datasets

    mesh = par.make_mesh(n_devices, device_type="cpu")

    # rows sharded over the mesh (257 rows: not a multiple of the ranks)
    vecs = torch.from_numpy(datasets.random_uniform(257, 8, seed=5))
    queries = torch.from_numpy(datasets.random_uniform(11, 8, seed=6))
    index = build_index(vecs, mesh=mesh)
    res = par.search_sharded(index, queries, 0.6, mesh)
    _same_sets(res.rows, _ball_sets(vecs, queries, 0.6), "sharded search")

    # the forest: one tree per rank, all-gather top-k merge
    forest = par.build_forest(vecs, mesh, leaf_size=4)
    _, d2, _ = par.forest_knn(forest, queries[:3], k=3, radius=2.0)
    _, ed2 = exact_knn(vecs, queries[:3], k=3)
    if not torch.allclose(d2.sort(1).values, ed2.sort(1).values,
                          rtol=1e-4, atol=1e-5):
        raise AssertionError("forest top-k merge mismatch")

    # the sharded scan: each rank scans its block, [Q, k] merge
    sdb = par.pack_database_sharded(vecs, mesh, block=64, buckets=64)
    srows, sd2 = par.sharded_scan_knn(sdb, queries[:8], k=3, q_tile=8)
    se_rows, se_d2 = exact_knn(vecs, queries[:8], k=3)
    if not torch.allclose(sd2.sort(1).values, se_d2.sort(1).values,
                          rtol=1e-4, atol=1e-5):
        raise AssertionError("sharded scan top-k mismatch")
    _same_sets(srows, [set(r) for r in se_rows.tolist()], "sharded scan")
    nb_loc = sdb.vb.shape[0]
    nrows, nd2 = par.sharded_scan_knn(sdb, queries[:8], k=3, q_tile=8,
                                      probes=nb_loc)
    if not (torch.equal(nrows, srows) and torch.allclose(nd2, sd2)):
        raise AssertionError("pruned sharded scan (full coverage) != "
                             "unpruned")
    prows, pd2 = par.sharded_scan_knn(sdb, vecs[:8], k=1, q_tile=8, probes=1)
    if not (((prows >= -1) & (prows < vecs.shape[0])).all()
            and torch.isfinite(pd2[:, 0]).all()):
        raise AssertionError("pruned sharded scan: an out-of-range id or a "
                             "query without candidates")
    rrows, rd2 = par.sharded_scan_knn(sdb, vecs[:8], k=1, q_tile=8, probes=1,
                                      probes_max=nb_loc)
    if not (torch.equal(rrows, prows) and torch.equal(rd2, pd2)):
        raise AssertionError("sharded runtime probes != static probes")
    srv = PackedServer(sdb, k=3, batch=8, q_tile=8)
    vrows, _ = srv.query(queries[:5])
    if tuple(vrows.shape) != (5, 3):
        raise AssertionError(f"PackedServer rows of shape {vrows.shape}")
    _same_sets(vrows, [set(r) for r in srows[:5].tolist()],
               "PackedServer over the sharded pack")

    # the sharded fused build: the single-device fused tree on integer data
    ivecs = torch.from_numpy(np.random.RandomState(9).randint(
        -4, 5, size=(403, 8)).astype(np.float32))
    sh = par.build_index_sharded(ivecs, mesh, leaf_size=2, stats_subsample=1)
    si = build_index_fused(ivecs, leaf_size=2, stats_subsample=1)
    for f in ("dim", "mid", "low", "high"):
        if not torch.equal(getattr(si, f), getattr(sh, f)):
            raise AssertionError(f"sharded fused {f} mismatch")
    rows, _, _, _ = par.search_global(sh, ivecs[:5], 1.5)
    _same_sets(rows, _ball_sets(ivecs, ivecs[:5], 1.5), "search_global")
    krows, _ = par.knn_global(sh, ivecs[:3], k=4, radius=3.0)
    if tuple(krows.shape) != (3, 4):
        raise AssertionError(f"knn_global rows of shape {krows.shape}")

    if n_devices >= 4 and n_devices % 2 == 0:
        # tensor parallel: rows over "data", vector dims over "model"
        mesh2 = par.make_mesh_2d(n_devices // 2, 2, device_type="cpu")
        index2 = build_index(vecs[:256], mesh=mesh2, dim_axis="model")
        res2 = par.search_sharded(index2, queries, 0.6, mesh2)
        _same_sets(res2.rows, _ball_sets(vecs[:256], queries, 0.6),
                   "tp-sharded search")

        # two slices: one sharded tree per slice, [Q, k] cross-slice merge
        if not par.init_distributed(device_type="cpu"):
            raise AssertionError("the world is not multi-process")
        msi = par.build_index_multislice(ivecs, n_slices=2, leaf_size=2,
                                         device_type="cpu")
        if msi.num_slices != 2:
            raise AssertionError(f"{msi.num_slices} slices")
        _, ed2 = exact_knn(ivecs, ivecs[:4], k=3)
        # the radius covers the true third neighbours
        mradius = float(torch.sqrt(ed2.max())) + 0.1
        _, md2 = par.knn_multislice(msi, ivecs[:4], k=3, radius=mradius)
        if not torch.allclose(md2.sort(1).values, ed2.sort(1).values,
                              rtol=1e-4, atol=1e-5):
            raise AssertionError("multi-slice knn mismatch")
        srows2, _, _, _ = par.search_multislice(msi, ivecs[:4], 1.5)
        _same_sets(srows2, _ball_sets(ivecs, ivecs[:4], 1.5),
                   "multi-slice search")
