#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each raises on failure; nothing is caught):

1. build the five CUDA sources from ``vector_database_tpu_torch/csrc``
   (``bucket_scan_sm90.cu``, the scan of bf16 and int8f packs,
   ``bucket_scan_i8.cu``, the exact int8 scan, and ``probe_kernel_ab.cu``,
   the A/B probe, all on the Hopper skeleton of ``sm90.cuh``;
   ``segment_moments.cu``, the build's segment moments, and
   ``delta_knn.cu``, the delta merge's k best), one ``nvcc`` each, all at
   once, and say whether the build was cold or found its libraries under
   ``build/`` already;
2. hold the kernel to the exact oracle where the scan is exact
   (n <= buckets: every row owns a bucket);
3. the main path at 10M x 96 clustered rows (the bench recipe: n/1000
   centres uniform in [-1, 1], sigma 0.05): fused build (leaf 16), the
   same build again on the same input (the node tables must be equal
   field by field), pack (4096 buckets), ``PackedServer`` full scan and
   pruned scans at probes 192/256/320, q=4096, recall@10 against the
   exact oracle on 1024 queries; the segment-moments kernel's launch
   count must rise by the build's depth, and the bf16 kernel's must rise;
4. the bf16 kernel against its plain torch version at the main path's
   shapes (full and pruned), with the two bitwise equalities of the
   pruned path (probes = nb equals the full scan; runtime probes equal
   static), its bound and a library yardstick (``torch.matmul`` of the
   same products, which no PyTorch call fuses with the bucket minimum);
5. exact radius ``search``/``knn`` through the tree at 1M x 8 against
   the oracle;
6. the int8 and int8f packs of the same 10M x 96 leaf-major matrix: pack
   time, block bytes (half the bf16 pack's) and scale; ``PackedServer``
   full scans over both (recall@10 >= 0.90) and pruned int8f scans at
   probes 192/256/320; the exact int8 kernel (K-major blocks, s8
   ``wgmma``) bitwise equal to its plain version, with its bound and the
   ``torch._int_mm`` yardstick; the int8f route of ``bucket_scan_sm90.cu``
   (full, and pruned to 256 blocks) within the bf16 tolerance (also on an
   int8f pack with a seeded 1% of rows masked), and the pruned int8f
   equalities of phase 4; both launch counts must rise; then the exact
   int8 kernel's uint8 form at the BIGANN cell's scan (U8_N x U8_D
   seeded integer rows in [0, 255], 0 and 255 included, through
   ``pack_database(dtype="uint8")``: 4096 buckets, block 8192; U8_Q
   queries, one wave) bitwise equal to its plain version, with its bound
   (2 Q N D operations at the int8 peak) and the ``torch._int_mm``
   yardstick; ``scan.launches.uint8`` must count every launch and
   ``scan.launches.int8`` none;
7. bucket counts no 64-column tile divides: ``pack_database(buckets=
   1000)`` (block 1000 by the default rule) of 1M x 96 clustered rows in
   bf16, int8f and int8, each served by ``PackedServer`` (recall@10
   against the exact oracle, the floors of phases 3 and 6); every scan
   kernel's launch count must rise; then each kernel against its plain
   version at m = 1000 (bitwise for the exact int8 scan and, on small
   integers, the probe; within the bf16 tolerance for the float scans);
8. the A/B scan probe: each mode bitwise equal to its plain version on
   small integers at 3 blocks, then its entry point times the four modes
   at 10M rows and 1024 queries (its JSON lines), and ``full`` is held
   bitwise to its plain version at that size, on small integers; then
   the four modes are timed again at the serving batch, q=4096, beside
   the scan kernel of phase 4 (the ``split_q4096_ms`` field);
9. the mutable collections. (a) ``DynamicIndex`` over the same 10M x 96
   rows: construction, a packed batch, ``remove_ids`` of a seeded 1% and
   10,000 adds kept in the delta, packed full and pruned (256) batches
   over the masked pack (QPS; recall@10 >= 0.98 against the live rows),
   no removed id ever returned, added rows their own nearest at 0, the
   base pack shared across the removal, ``knn(exact=True)`` equal to the
   oracle, ``compact()``; then the kernel alone on the masked norm row
   against its plain version, full and pruned. (b) ``DocumentStore`` of
   200 documents x 5,000 texts (1M x 96): ingest, the combined build,
   ``knn_batch(packed=True)`` (recall@10 >= 0.98), per-document k-NN and
   ``search_batch`` equal to the oracles, 1,000 adds served from the
   delta without a rebuild. The kernel's launch count must rise in each.
10. out-of-core serving: OOC_N x D rows of the recipe (n/1000 centres,
   three seeded chunks made on the card) written into a
   ``NativeVectorStore`` under ``build/``, then ``ChunkedIndex.from_store``
   in chunks of OOC_CHUNK (leaf 16, block 8192, 4096 buckets, d_align 16:
   d_pad 96); at q=4096, k=10: streamed ``knn``, ``pin()``, pinned
   pipelined and sequential ``knn`` (full and pruned to 256 blocks; each
   pair bitwise equal, streamed bitwise equal to pinned) and the device
   rerank (``host_rerank=False``, ids equal to the host rerank's), recall@10
   >= 0.98 of the full modes against an exact oracle over all rows, a
   chunk's scan and host rerank timed alone; the bf16 kernel's launch
   count must rise. Then the kernel alone at a pinned chunk's shape
   (d_pad 96, 1221 blocks), full and pruned 256, against its plain
   version, with its bound and ``torch.matmul`` yardstick (the pruned one
   too: its plain time, bound and yardstick). Small checks at
   1M x 8 in 4 chunks: ``search`` equal to ``exact_ball``; ``save`` ->
   ``load``, ``spill_dir`` and a checkpointed ``from_store`` stopped after
   chunk 2 and resumed, each serving the same answers bit for bit;
11. the in-memory models: ``MemoryVectorIndex`` of 100,000 seeded records
   in [-1, 1]^8 (``find``, ``find_batch``, ``to_bsp`` -> ``search`` /
   ``locate``, ``remove``), ``BoolMatrixIndex`` of 100,000 x 64
   (``identify_batch`` of 4096 stored rows, ``knn_hamming``,
   ``find_hamming``), each against a numpy oracle, and ``heap_rows`` ->
   ``from_heap_rows`` of a leaf_size=1 tree of 100,000 x 8.
12. the multi-device layer on ``make_mesh()``: a world of one rank over
   NCCL (the script needs one GPU, and NCCL takes one rank per GPU).
   The 10M x 96 rows of phase 3 made again: ``build_index_sharded`` equal
   to ``build_index_fused`` field by field (at one rank every collective
   returns its input's bits), both timed; ``to_bsp`` the same tree;
   ``pack_database_sharded`` + ``sharded_scan_knn`` at q=4096 (full,
   static pruned 256, runtime pruned 256 with ``probes_max=320``) equal to
   the single-device scan (ids through ``orig_row``, distances bitwise);
   ``PackedServer`` over the sharded pack (QPS, recall@10 >= 0.98) beside
   the single-device server; the bf16 kernel's launch count must rise in
   the sharded serve; at 1M x 8, ``search_global``/``knn_global``,
   ``build_forest`` + ``forest_knn``, ``search_sharded``/``knn_sharded``
   and ``build_index_multislice(n_slices=1)`` with ``knn_multislice``/
   ``search_multislice`` against the oracles.
13. the host-loop build (``build_index`` over ``ops/level.py``): the
   10M x 96 rows of phase 3 made again, built twice (the tables must be
   equal field by field), timed beside phase 3's fused build, with the
   depth, the leaves and each level's time (``BuildStats``), and the
   per-level host copy timed alone at the widest level; its leaf-major
   matrix packed (4096 buckets) and served by ``PackedServer`` full scan
   at q=4096 (recall@10 >= 0.98; ``bucket_scan``'s launch count must rise);
   at world size 1 over NCCL ``build_index(mesh=make_mesh())`` and
   ``build_index(mesh=make_mesh_2d(1, 1), dim_axis="model")`` over the
   same N x D rows equal the single-device tree bit for bit;
   ``one_hot_crafted(1536)`` gives the fused build's tree; the forward of
   the ``__graft_entry__.py`` twin (``entry.py``) runs on the card and equals
   ``exact_knn`` on every query whose ball holds k rows. The process
   group of phases 12-13 is destroyed at the end.
14. the measurement harnesses of ``vector_database_tpu_torch/benchmarks/``,
   each through its ``main(argv)`` in this process at a reduced size
   (HARNESS_N = 1M rows of 96): ``recall_qps`` (full, pruned 64/128, the
   buckets x oversample sweep, the world-size-1 mesh, the tree walk;
   packed recall@10 >= 0.98, the sharded recalls equal to the
   single-device ones), ``latency`` (full recall@10 >= 0.98 at every
   batch, p99 >= p50 > 0), ``probe_epilogue`` full and pruned,
   ``probe_select``, ``probe_host_rerank`` (``inplace`` and the
   production rerank bitwise ``diff``), ``probe_pin_pipeline`` at 2M in
   500k chunks (pipelined == sequential bitwise, asserted by the harness),
   ``bigscale`` at 3M in 1M chunks under ``build/`` (sampled recall >=
   0.98, the store removed), ``probe_churn`` (both packs survive),
   ``crossover`` at 200k over d 2/8/96, ``probe_fullscan``,
   ``probe_kernel``, ``probe_block`` (two configurations each),
   ``probe_build``, ``probe_ops``, ``probe_perm`` (the three inverses
   equal), ``probe_meanid`` (every formulation equal to the int64 id
   sums), ``probe_sharded_mem`` (the fused and world-of-one sharded trees
   equal, each build's peak memory) and ``main_test``; every scan
   kernel's launch count must rise over the phase.
15. the headline bench, ``vector_database_tpu_torch.bench.main`` in this
   process at its defaults (10M x 96, leaf 16; the clustered recipe
   served at q=4096, 4096 buckets, probes 192/256/320, 20 reps; the
   sharded build field and the mesh serving leg on a world of one rank):
   return value 0, no ``*_error`` field, JAX's key set, full recall@10
   >= 0.98, three pruned points, the sharded full and pruned rows bitwise
   the single-device rows; ``bucket_scan``'s launch count must rise. Then
   its ingest (``VDB_BENCH_INGEST=1``), sharded-primary
   (``VDB_BENCH_SHARDED=1``) and ``VDB_BENCH_TIE=mean_id`` legs, each cut
   to BENCH_CUT_N = 1M rows: return value 0 and JAX's key set. No process
   group may be left behind.
16. the build's segment-moments kernel at the main path's shape (N x D
   clustered rows, every 4th row sampled), for one segment of every row
   (a build's first level) and for segments of 17 rows (~590k, the
   deepest levels), each read as the build reads it (through a row index
   that ascends inside each segment), through a shuffled index and with
   no index: kernel and plain version timed, the bound (bytes read once,
   the index's 8 B a sample included, and written once at the card's
   memory rate), and each version's largest error against float64 sums
   in ulps of the segment's sum of |x|; through an index the kernel must
   equal itself on the gathered rows bit for bit; the kernel's launch
   count must rise with each call.
17. the delta merge's k-NN kernel (``ops.delta_knn``) at the churn
   cell's shape: DELTA_Q = 10,000 queries (half near-duplicates of live
   rows, noise 0.002 a dimension) against DELTA_R = 16,384 padded slots
   of unit rows, DELTA_LIVE = 10,000 live, D = 96, k = 10: kernel and
   plain version (``exact_d2_blocked`` + mask + ``_lowest_k``) timed, the
   bound (3 Q D R f32 operations at the f32 peak, as the benchmark's
   ``merge_roofline_pct`` counts them), the library yardstick
   ``torch.cdist`` + ``torch.topk`` (timed only: the port never calls
   it), the distances against float64 (within 2e-5 relative), the ids
   against the plain version where the k-th place is clear, integer rows
   bit for bit, and the launch count.

It prints the card's name and power limit, one JSON line each of the
main path's, phase 7's, phase 9's, phases 10-11's, phase 12's
(``{"mesh": ...}``), phase 13's (``{"host_loop": ...}``), phase 14's
(``{"harness": ...}``) and phase 15's (``{"bench": ...}``) results, one
JSON line of kernel results (each
kernel with its time, its plain version's, its bound from this run's
shapes and the card's
published peaks, the library yardstick, TFLOP/s and share of the bound),
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
N, D, Q, K = 10_000_000, 96, 4096, 10
LEAF, BUCKETS, TRUTH_Q = 16, 4096, 1024
PROBES = (192, 256, 320)
TREE_N, TREE_D = 1_000_000, 8
REMOVE, ADD, EXACT_Q, PROBE = N // 100, 10_000, 256, 256
TAIL_N, TAIL_BUCKETS, TAIL_Q = 1_000_000, 1000, 1024
U8_N, U8_D, U8_Q = 10_000_000, 128, 1024  # the uint8 scan of bigann-10M
STORE_DOCS, STORE_TEXTS, STORE_ADD, SEARCH_Q = 200, 5000, 1000, 64
OOC_N, OOC_CHUNK, OOC_PROBES = 30_000_000, 10_000_000, 256
DELTA_Q, DELTA_R, DELTA_LIVE = 10_000, 16_384, 10_000
SMALL_N, SMALL_D, SMALL_CHUNK, SMALL_Q = 1_000_000, 8, 250_000, 64
MODEL_N, MODEL_D, MODEL_Q, BOOL_P, BOOL_Q = 100_000, 8, 64, 64, 4096
HARNESS_N = 1_000_000
REPS = 3
DEVICE = "cuda"
# NVIDIA H100 SXM published peaks (dense): bf16 and int8 tensor cores, HBM
PEAK_BF16, PEAK_INT8, PEAK_HBM = 989e12, 1979e12, 3.35e12
PEAK_F32 = 67e12  # float32 outside the tensor cores
LIB_BLOCKS = 8  # blocks per library-yardstick call, scaled to the scan


def _ms(fn, reps):
    """Median milliseconds of ``reps`` runs of ``fn`` (CUDA events)."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _clustered(dev, n, seed):
    """The bench recipe: n/1000 centres uniform in [-1, 1], sigma 0.05;
    ``(train [n, D], test [Q, D], centres, generator)`` on ``dev``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    c = n // 1000
    centers = torch.rand((c, D), generator=g, device=dev) * 2 - 1
    train = torch.randn((n, D), generator=g, device=dev).mul_(0.05)
    train += centers[torch.randint(0, c, (n,), generator=g, device=dev)]
    test = _fresh(centers, Q, g)
    return train, test, centers, g


def _fresh(centers, n, g):
    """``n`` more rows from the recipe's distribution."""
    import torch

    dev = centers.device
    rows = centers[torch.randint(0, centers.shape[0], (n,), generator=g,
                                 device=dev)]
    return rows + 0.05 * torch.randn((n, D), generator=g, device=dev)


def _recall(rows, truth):
    rows, truth = rows.cpu().tolist(), truth.cpu().tolist()
    return sum(len(set(r) & set(t)) for r, t in zip(rows, truth)) / \
        sum(len(t) for t in truth)


def _score_tol(scores, bits):
    """Kernel vs plain tolerance on a decoded score: both sum d_pad exact
    bf16 products in f32 in different orders (1e-5 relative plus 1e-4
    absolute covers it at |score| <= ~100), and the encode masks the low
    ``bits`` mantissa bits (2^(bits-22) relative)."""
    return scores.abs() * (2.0 ** (bits - 22) + 1e-5) + 1e-4


def _compare_acc(got, want, pack, qb):
    """Decoded scores agree within ``_score_tol``; where the block ids
    differ, the two blocks' own scores for that bucket are within the
    tolerance of each other (the gap is too small to order them)."""
    import torch

    mask = (1 << pack.bits) - 1
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    gs = (gi & ~mask).view(torch.float32)
    ws = (wi & ~mask).view(torch.float32)
    tol = _score_tol(ws, pack.bits)
    err = (gs - ws).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"kernel scores off by {float(err.max())}")
    qi, ci = torch.nonzero((gi & mask) != (wi & mask), as_tuple=True)
    if qi.numel():
        m, w = pack.m, pack.block // pack.m
        cols = ci[:, None] + m * torch.arange(w, device=ci.device)[None, :]
        qf = qb[qi].float()

        def score(b):
            v = pack.vb[b[:, None], :, cols].float()  # [M, w, d_pad]
            s = pack.vn[b[:, None], 0, cols] + (v @ qf[:, :, None])[..., 0]
            return s.amin(dim=1)

        gap = (score((gi & mask)[qi, ci].long())
               - score((wi & mask)[qi, ci].long())).abs()
        if not bool((gap <= 2 * tol[qi, ci]).all()):
            raise AssertionError("kernel picked a block the plain version "
                                 "beats by more than the tolerance")
    return float(err.max()), qi.numel() / gi.numel()


def _bound(ops, nbytes, peak):
    """``(bound_ms, bound_by)``: the least time for ``ops`` operations at
    ``peak`` per second and ``nbytes`` of inputs read once and outputs
    written once at the card's memory rate, whichever is larger."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _numbers(ms, ops, nbytes, peak, library_ms):
    """The kernel JSON's measured and derived numbers for one kernel."""
    bound_ms, bound_by = _bound(ops, nbytes, peak)
    return dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, tflops=ops / ms / 1e9,
                pct_of_bound=100.0 * bound_ms / ms)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _matmul_ms(q, vb, blocks):
    """Library yardstick, products only: ``torch.matmul`` of the bf16
    queries against LIB_BLOCKS blocks at once, scaled to ``blocks``."""
    import torch

    part = vb[:LIB_BLOCKS] if vb.dtype == torch.bfloat16 else \
        vb[:LIB_BLOCKS].bfloat16()
    return _ms(lambda: torch.matmul(q, part), REPS) * blocks / LIB_BLOCKS


def _int_mm_ms(qi, vb, blocks):
    """Library yardstick of the exact int8 scan: ``torch._int_mm`` per
    block (int8 x int8 -> int32 products) against the K-major blocks as
    they lie (``vb[b].T``, or a contiguous copy made before the clock
    starts where the call refuses that layout), scaled to ``blocks``;
    None where the call takes neither."""
    import torch

    mats = [vb[b].T for b in range(LIB_BLOCKS)]
    for layout in (mats, [x.contiguous() for x in mats]):
        try:
            t = _ms(lambda: [torch._int_mm(qi, x) for x in layout], REPS)
        except RuntimeError:
            continue
        return t * blocks / LIB_BLOCKS
    return None


def _same_tree(a, b):
    """Two ``BSPIndex`` node tables equal field by field, bit for bit."""
    import torch

    fields = ("dim", "mid", "low", "high", "leaf_start", "leaf_count",
              "orig_row")
    return (a.depth, a.num_leaves) == (b.depth, b.num_leaves) and all(
        torch.equal(getattr(a, f).view(torch.int32),
                    getattr(b, f).view(torch.int32)) for f in fields)


def _host_ms(fn, reps):
    """Median milliseconds of ``reps`` runs of ``fn``, host clock, each
    ending in a synchronise (for entry points that return host arrays)."""
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _check_knn(got_ids, got_d2, want_ids, want_d2, what):
    """``(ids, d2)`` numpy results against an exact oracle: sorted
    distances within rtol 1e-5 and atol 1e-4 (both sides round |q|^2 +
    |v|^2 - 2 q.v, or the difference form, in f32 with |q|^2 and |v|^2
    near 32, where one ulp is 3.8e-6), and equal id sets except for ids
    whose distance ties the k-th within that tolerance. Returns the
    number of such ties."""
    import numpy as np

    np.testing.assert_allclose(got_d2, want_d2, rtol=1e-5, atol=1e-4,
                               err_msg=what)
    ties = 0
    for gi, gd, wi, wd in zip(got_ids, got_d2, want_ids, want_d2):
        extra = ~np.isin(gi, wi)
        missing = ~np.isin(wi, gi)
        if extra.sum() != missing.sum():
            raise AssertionError(f"{what}: id sets differ in size")
        bound = 1e-4 + 1e-5 * abs(float(wd[-1]))
        if (gd[extra] < wd[-1] - bound).any() or \
                (wd[missing] < gd[-1] - bound).any():
            raise AssertionError(f"{what}: ids {gi} != oracle {wi}")
        ties += int(extra.sum())
    return ties


def _dynamic_phase(dev):
    """Phase 8a: ``DynamicIndex`` at N x D with churn, packed serving
    over the masked pack, the exact scan, compaction; then the kernel
    alone on the masked norm row."""
    import numpy as np
    import torch

    from vector_database_tpu_torch import DynamicIndex, exact_knn
    from vector_database_tpu_torch.ops import bucket_scan as bs
    from vector_database_tpu_torch.ops.packed_knn import _block_map
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    out = {}
    train, test, centers, g = _clustered(dev, N, SEED)
    torch.cuda.synchronize()
    COUNTERS["scan.launches.bf16"] = 0
    t0 = time.perf_counter()
    idx = DynamicIndex(train, leaf_size=LEAF, device=dev)
    torch.cuda.synchronize()
    out["construct_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.knn(test, K, packed=True)
    out["first_packed_s"] = time.perf_counter() - t0
    base = idx._main.pack
    print(f"[dynamic] {N}x{D} leaf {LEAF}: construct "
          f"{out['construct_s']:.3f} s; first packed batch q={Q} (pack "
          f"included) {out['first_packed_s']:.3f} s")

    removed = torch.randperm(N, generator=g, device=dev)[:REMOVE]
    removed = np.sort(removed.cpu().numpy())
    t0 = time.perf_counter()
    if idx.remove_ids(removed) != REMOVE:
        raise AssertionError("remove_ids did not remove every id")
    out["remove_ids_s"] = time.perf_counter() - t0
    fresh = _fresh(centers, ADD, g)
    t0 = time.perf_counter()
    fresh_ids = idx.add(fresh)
    out["add_s"] = time.perf_counter() - t0
    if idx._delta.size != ADD or len(idx) != N - REMOVE + ADD:
        raise AssertionError("the adds did not stay in the delta")

    t0 = time.perf_counter()
    ids, d2 = idx.knn(test, K, packed=True)
    out["first_packed_after_remove_s"] = time.perf_counter() - t0
    if idx._main.pack is not base or idx._main_view().pack.vb is not base.vb:
        raise AssertionError("the removal rebuilt the base pack")
    out["packed_ms"] = _host_ms(lambda: idx.knn(test, K, packed=True), REPS)
    q_dev = torch.as_tensor(test, device=dev)
    merges0 = COUNTERS["dynamic.delta_knn.launches"]
    out["delta_merge_ms"] = _host_ms(
        lambda: idx.merge_delta(q_dev, ids, d2, K), REPS)
    out["delta_knn_launches"] = COUNTERS["dynamic.delta_knn.launches"] - \
        merges0
    if out["delta_knn_launches"] < 1:
        raise AssertionError("merge_delta never launched delta_knn")
    out["packed_qps"] = Q / out["packed_ms"] * 1e3

    alive = torch.ones(N, dtype=torch.bool, device=dev)
    alive[torch.from_numpy(removed).to(dev)] = False
    live = torch.cat([train[alive], fresh])
    live_ids = np.concatenate([torch.nonzero(alive)[:, 0].cpu().numpy(),
                               fresh_ids])
    del train
    truth_pos, truth_d2 = exact_knn(live, test[:TRUTH_Q], k=K)
    truth = torch.as_tensor(live_ids[truth_pos.cpu().numpy()])
    out["packed_recall"] = _recall(torch.as_tensor(ids[:TRUTH_Q]), truth)
    seen = [ids]

    t0 = time.perf_counter()
    pids, _ = idx.knn(test, K, packed=True, probes=PROBE)
    out["pruned_first_s"] = time.perf_counter() - t0
    out["pruned_ms"] = _host_ms(
        lambda: idx.knn(test, K, packed=True, probes=PROBE), REPS)
    out["pruned_qps"] = Q / out["pruned_ms"] * 1e3
    out["pruned_recall"] = _recall(torch.as_tensor(pids[:TRUTH_Q]), truth)
    seen.append(pids)
    print(f"[dynamic] removed {REMOVE} ids in {out['remove_ids_s']:.3f} s, "
          f"added {ADD} rows in {out['add_s']:.3f} s; packed q={Q}: first "
          f"{out['first_packed_after_remove_s']:.3f} s, steady "
          f"{out['packed_ms']:.3f} ms ({out['packed_qps']:.1f} QPS, delta "
          f"merge alone {out['delta_merge_ms']:.3f} ms), recall@{K} "
          f"{out['packed_recall']:.4f}; pruned {PROBE}: "
          f"{out['pruned_ms']:.3f} ms ({out['pruned_qps']:.1f} QPS), "
          f"recall@{K} {out['pruned_recall']:.4f}")
    if out["packed_recall"] < 0.98:
        raise AssertionError(f"DynamicIndex packed recall@{K} "
                             f"{out['packed_recall']} < 0.98")

    own, own_d2 = idx.knn(fresh[:1024], K, packed=True)
    seen.append(own)
    if not (np.array_equal(own[:, 0], fresh_ids[:1024])
            and (own_d2[:, 0] == 0).all()):
        raise AssertionError("an added row is not its own nearest at 0")

    eids, ed2 = idx.knn(test[:EXACT_Q], K, exact=True)
    seen.append(eids)
    wd2 = truth_d2[:EXACT_Q].cpu().numpy()
    wids = live_ids[truth_pos[:EXACT_Q].cpu().numpy()]
    out["exact_ties"] = _check_knn(eids, ed2, wids, wd2, "knn(exact=True)")
    out["exact_ms"] = _host_ms(lambda: idx.knn(test[:EXACT_Q], K,
                                               exact=True), 1)
    for got in seen:
        if np.isin(got, removed).any():
            raise AssertionError("a removed id was returned")
    print(f"[dynamic] added rows found at distance 0; no removed id "
          f"returned; base pack shared; knn(exact=True) on {EXACT_Q} "
          f"queries == oracle ({out['exact_ties']} ties at the k-th), "
          f"{out['exact_ms']:.3f} ms")
    del live, truth_pos, truth_d2

    masked = idx._main_view().pack
    t0 = time.perf_counter()
    idx.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cids, _ = idx.knn(test, K, packed=True)
    out["packed_after_compact_s"] = time.perf_counter() - t0
    if np.isin(cids, removed).any() or len(idx) != N - REMOVE + ADD:
        raise AssertionError("compaction lost or revived rows")
    torch.cuda.synchronize()
    out["launches"] = COUNTERS["scan.launches.bf16"]
    if out["launches"] < 1:
        raise AssertionError("DynamicIndex never launched bucket_scan")
    print(f"[dynamic] compact {out['compact_s']:.3f} s, then a packed "
          f"batch {out['packed_after_compact_s']:.3f} s; bucket_scan "
          f"launches {out['launches']}")
    del idx

    # the kernel alone on the masked norm row, full and pruned
    d_pad = masked.d_pad
    qb = torch.zeros((Q, d_pad), device=dev)
    qb[:, :D] = test
    qb = qb.bfloat16()
    args = dict(m=masked.m, bits=masked.bits)
    err, mis = _compare_acc(bs.bucket_scan(masked.vn, masked.vb, qb, **args),
                            bs.bucket_scan_reference(masked.vn, masked.vb,
                                                     qb, **args),
                            masked, qb)
    out["kernel_masked_max_abs_err"] = err
    out["kernel_masked_ms"] = _ms(
        lambda: bs.bucket_scan(masked.vn, masked.vb, qb, **args), REPS)
    out["kernel_masked_plain_ms"] = _ms(
        lambda: bs.bucket_scan_reference(masked.vn, masked.vb, qb, **args),
        REPS)
    order, bmap = _block_map(masked, test, q_tile=512, probes=PROBE)
    qs = qb[order]
    pargs = dict(args, bmap=bmap, nprobe=PROBE, q_tile=512)
    perr, pmis = _compare_acc(
        bs.bucket_scan(masked.vn, masked.vb, qs, **pargs),
        bs.bucket_scan_reference(masked.vn, masked.vb, qs, **pargs),
        masked, qs)
    out["kernel_masked_pruned256_max_abs_err"] = perr
    out["kernel_masked_pruned256_ms"] = _ms(
        lambda: bs.bucket_scan(masked.vn, masked.vb, qs, **pargs), REPS)
    out["kernel_masked_pruned256_plain_ms"] = _ms(
        lambda: bs.bucket_scan_reference(masked.vn, masked.vb, qs, **pargs),
        REPS)
    print(f"[dynamic] kernel on the masked pack: full "
          f"{out['kernel_masked_ms']:.3f} ms (plain "
          f"{out['kernel_masked_plain_ms']:.3f}), max |score err| "
          f"{err:.3g}, block-id ties {mis:.2e}; pruned {PROBE} "
          f"{out['kernel_masked_pruned256_ms']:.3f} ms (plain "
          f"{out['kernel_masked_pruned256_plain_ms']:.3f}), max |score err| "
          f"{perr:.3g}")
    return out


def _store_phase(dev):
    """Phase 8b: ``DocumentStore`` of STORE_DOCS x STORE_TEXTS texts:
    ingest, the combined build, packed and per-document k-NN, batched
    radius search, and adds served from the delta."""
    import numpy as np
    import torch

    from vector_database_tpu_torch import DocumentStore, exact_ball, exact_knn
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    out = {}
    n = STORE_DOCS * STORE_TEXTS
    train, test, centers, g = _clustered(dev, n, SEED + 3)
    host = train.cpu().numpy()
    COUNTERS["scan.launches.bf16"] = 0
    store = DocumentStore(leaf_size=LEAF, device=dev)
    t0 = time.perf_counter()
    docs = [store.create_document(f"doc{i}") for i in range(STORE_DOCS)]
    for i, doc in enumerate(docs):
        for row in host[i * STORE_TEXTS:(i + 1) * STORE_TEXTS]:
            store.add_text(doc, row)  # text ids 1..n in row order
    out["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store._combined_view()
    torch.cuda.synchronize()
    out["combined_build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    store.knn_batch(test, K, packed=True)
    out["first_packed_s"] = time.perf_counter() - t0
    out["packed_ms"] = _host_ms(lambda: store.knn_batch(test, K,
                                                        packed=True), REPS)
    out["packed_qps"] = Q / out["packed_ms"] * 1e3
    _, texts, _ = store.knn_batch(test, K, packed=True)
    truth = exact_knn(train, test[:TRUTH_Q], k=K)[0] + 1  # row -> text id
    out["packed_recall"] = _recall(torch.as_tensor(texts[:TRUTH_Q]), truth)
    print(f"[store] {STORE_DOCS} docs x {STORE_TEXTS} texts ({n}x{D}): "
          f"ingest {out['ingest_s']:.3f} s, combined build "
          f"{out['combined_build_s']:.3f} s; knn_batch(packed) q={Q}: first "
          f"{out['first_packed_s']:.3f} s, steady {out['packed_ms']:.3f} ms "
          f"({out['packed_qps']:.1f} QPS), recall@{K} "
          f"{out['packed_recall']:.4f}")
    if out["packed_recall"] < 0.98:
        raise AssertionError(f"DocumentStore packed recall@{K} "
                             f"{out['packed_recall']} < 0.98")

    doc = 7
    lo = (doc - 1) * STORE_TEXTS
    dd, dt, dd2 = store.knn_batch(test[:EXACT_Q], K, doc_id=doc)
    want_pos, want_d2 = exact_knn(train[lo:lo + STORE_TEXTS], test[:EXACT_Q],
                                  k=K)
    if (dd != doc).any():
        raise AssertionError("knn_batch(doc_id=) left the document")
    out["doc_ties"] = _check_knn(dt, dd2, want_pos.cpu().numpy() + lo + 1,
                                 want_d2.cpu().numpy(), "knn_batch(doc_id)")

    gq = torch.Generator(device=dev).manual_seed(SEED + 5)
    pts = train[torch.randint(0, n, (SEARCH_Q,), generator=gq, device=dev)]
    radius = 0.6
    t0 = time.perf_counter()
    hits = store.search_batch(pts, radius)
    out["search_batch_s"] = time.perf_counter() - t0
    want = [set() for _ in range(SEARCH_Q)]
    for s in range(0, n, 65536):
        qi, ri = torch.nonzero(exact_ball(train[s:s + 65536], pts, radius),
                               as_tuple=True)
        for a, b in zip(qi.tolist(), ri.tolist()):
            want[a].add(s + b + 1)
    for i in range(SEARCH_Q):
        if {t for _, t, _ in hits[i]} != want[i]:
            raise AssertionError(f"search_batch != exact_ball, query {i}")
    out["search_matches"] = sum(len(w) for w in want)
    print(f"[store] knn_batch(doc_id={doc}) on {EXACT_Q} queries == "
          f"exact_knn over its rows ({out['doc_ties']} ties at the k-th); "
          f"search_batch r={radius} on {SEARCH_Q} rows == exact_ball "
          f"({out['search_matches']} matches) in "
          f"{out['search_batch_s']:.3f} s")

    builds = store.combined_builds
    extra = _fresh(centers, STORE_ADD, g).cpu().numpy()
    new_tids = [store.add_text(docs[i % STORE_DOCS], row)
                for i, row in enumerate(extra)]
    t0 = time.perf_counter()
    _, got, got_d2 = store.knn_batch(extra, K, packed=True)
    out["delta_packed_s"] = time.perf_counter() - t0
    if store.combined_builds != builds or len(store._delta) != STORE_ADD:
        raise AssertionError("add_text rebuilt the combined index")
    if not (np.array_equal(got[:, 0], new_tids) and (got_d2[:, 0] == 0).all()):
        raise AssertionError("an added text is not its own nearest at 0")
    torch.cuda.synchronize()
    out["launches"] = COUNTERS["scan.launches.bf16"]
    if out["launches"] < 1:
        raise AssertionError("DocumentStore never launched bucket_scan")
    print(f"[store] {STORE_ADD} add_text rows served from the delta at "
          f"distance 0 ({out['delta_packed_s']:.3f} s for the batch), no "
          f"rebuild; bucket_scan launches {out['launches']}")
    return out


def _uint8_scan(dev):
    """Phase 6's uint8 form of the exact int8 kernel at the BIGANN cell's
    scan: U8_N x U8_D seeded integer rows in [0, 255] (rows and queries
    at 0 and at 255 among them) through ``pack_database(dtype="uint8",
    buckets=BUCKETS)``, U8_Q queries through ``_scan_queries``; the
    kernel's scores and block ids bitwise its plain version's, its time,
    bound and ``torch._int_mm`` yardstick, and its launches, counted
    apart from the symmetric form's."""
    import torch

    from vector_database_tpu_torch import pack_database
    from vector_database_tpu_torch.ops import bucket_scan_i8 as bi
    from vector_database_tpu_torch.ops.packed_knn import _scan_queries
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    draw = dict(generator=g, device=dev, dtype=torch.uint8)
    rows = torch.randint(0, 256, (U8_N, U8_D), **draw).float()
    rows[0], rows[1] = 0.0, 255.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pack = pack_database(rows, buckets=BUCKETS, dtype="uint8")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    if (pack.dtype, pack.block, pack.m) != ("uint8", 8192, BUCKETS):
        raise AssertionError(f"uint8 pack: {pack.dtype}, block "
                             f"{pack.block}, m {pack.m}")
    qp = torch.zeros((U8_Q, pack.d_pad), device=dev)
    qp[:, :U8_D] = torch.randint(0, 256, (U8_Q, U8_D), **draw).float()
    qp[0, :U8_D], qp[1, :U8_D] = 0.0, 255.0
    qi = _scan_queries(pack, qp)
    COUNTERS["scan.launches.uint8"] = COUNTERS["scan.launches.int8"] = 0

    def kernel():
        return bi.bucket_scan_i8(pack.vn, pack.vb, qi, m=pack.m, uint8=True)

    def plain():
        return bi.bucket_scan_i8_reference(pack.vn, pack.vb, qi, m=pack.m,
                                           uint8=True)

    sk, ik = kernel()
    sp, ip = plain()
    err = float((sk - sp).abs().max())
    if not (torch.equal(sk, sp) and torch.equal(ik, ip)):
        raise AssertionError(f"uint8 kernel != plain: max |score err| "
                             f"{err}, {int((ik != ip).sum())} block ids "
                             f"differ")
    ms, plain_ms = _ms(kernel, REPS), _ms(plain, REPS)
    nb = pack.vb.shape[0]
    out = dict(n=U8_N, d=U8_D, q=U8_Q, blocks=nb, pack_s=pack_s,
               max_abs_err=err, plain_ms=plain_ms, **_numbers(
                   ms, 2 * U8_Q * U8_N * U8_D,
                   _nbytes(pack.vb, pack.vn, qi, sk, ik), PEAK_INT8,
                   _int_mm_ms(qi, pack.vb, nb)))
    out["launches"] = COUNTERS["scan.launches.uint8"]
    if out["launches"] != 2 + REPS or COUNTERS["scan.launches.int8"]:
        raise AssertionError(
            f"uint8 scan launches: uint8 {out['launches']} (want "
            f"{2 + REPS}), int8 {COUNTERS['scan.launches.int8']} (want 0)")
    print(f"[int8] uint8 form {U8_N}x{U8_D} ({nb} K-major blocks), {U8_Q} "
          f"queries: pack {pack_s:.3f} s; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, scores and block ids bitwise equal; bound "
          f"{out['bound_ms']:.3f} ms ({out['bound_by']}), "
          f"{out['tflops']:.1f} TOP/s, {out['pct_of_bound']:.1f}% of "
          f"bound; torch._int_mm {out['library_ms']}; launches uint8 "
          f"{out['launches']}, int8 0")
    return out


def _tail_phase(dev):
    """Phase 7: ``pack_database(buckets=TAIL_BUCKETS)`` of TAIL_N x D rows
    (block 1000 by the default rule: the grid's last CTA takes a partial
    64-column tile, and int8f rows of 1000 bytes are padded to 1008) in
    bf16, int8f and int8, served through ``PackedServer``; then each
    kernel against its plain version at m = 1000 on TAIL_Q queries."""
    import torch

    from vector_database_tpu_torch import PackedServer, exact_knn, pack_database
    from vector_database_tpu_torch.benchmarks import probe_kernel_ab as pab
    from vector_database_tpu_torch.ops import bucket_scan as bs
    from vector_database_tpu_torch.ops import bucket_scan_i8 as bi
    from vector_database_tpu_torch.ops.packed_knn import _scan_queries
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    out = {}
    train, test, _, g = _clustered(dev, TAIL_N, SEED + 6)
    truth = exact_knn(train, test[:TRUTH_Q], k=K)[0]
    packs = {}
    torch.cuda.synchronize()
    COUNTERS["scan.launches.bf16"] = COUNTERS["scan.launches.int8f"] = 0
    COUNTERS["scan.launches.int8"] = 0
    for dtype, floor in (("bfloat16", 0.98), ("int8f", 0.90), ("int8", 0.90)):
        p = pack_database(train, buckets=TAIL_BUCKETS, dtype=dtype)
        if not p.m == p.block == TAIL_BUCKETS:
            raise AssertionError(f"{dtype} pack: m {p.m}, block {p.block}")
        srv = PackedServer(p, k=K, batch=Q)
        srv.warmup()
        ms = _ms(lambda: srv.query(test), REPS)
        rec = _recall(srv.query(test)[0][:TRUTH_Q], truth)
        out[dtype] = dict(ms=ms, qps=Q / ms * 1e3, recall=rec)
        print(f"[tail] {dtype} pack of {TAIL_N}x{D}, buckets "
              f"{TAIL_BUCKETS}: m {p.m}, block {p.block}, row stride of vb "
              f"{bs.row_stride(p.vb)}; full scan q={Q}: {ms:.3f} ms, "
              f"{Q / ms * 1e3:.1f} QPS, recall@{K} {rec:.4f}")
        if rec < floor:
            raise AssertionError(f"{dtype} recall@{K} at m = {p.m}: {rec} "
                                 f"< {floor}")
        packs[dtype] = p
    torch.cuda.synchronize()
    out["launches"] = dict(bucket_scan=COUNTERS["scan.launches.bf16"],
                           bucket_scan_int8f=COUNTERS["scan.launches.int8f"],
                           bucket_scan_i8=COUNTERS["scan.launches.int8"])
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"m = {TAIL_BUCKETS} launches: {out['launches']}")

    # each kernel against its plain version at m = 1000
    p16 = packs["bfloat16"]
    qp = torch.zeros((TAIL_Q, p16.d_pad), device=dev)
    qp[:, :D] = test[:TAIL_Q]
    for dtype in ("bfloat16", "int8f"):
        p = packs[dtype]
        qs = _scan_queries(p, qp)
        args = dict(m=p.m, bits=p.bits)
        err, mis = _compare_acc(bs.bucket_scan(p.vn, p.vb, qs, **args),
                                bs.bucket_scan_reference(p.vn, p.vb, qs,
                                                         **args), p, qs)
        out[dtype].update(max_abs_err=err, block_id_ties=mis)
    p8 = packs["int8"]
    qi = _scan_queries(p8, qp)
    sk, ik = bi.bucket_scan_i8(p8.vn, p8.vb, qi, m=p8.m)
    sp, ip = bi.bucket_scan_i8_reference(p8.vn, p8.vb, qi, m=p8.m)
    out["int8"]["max_abs_err"] = float((sk - sp).abs().max())
    if not (torch.equal(sk, sp) and torch.equal(ik, ip)):
        raise AssertionError("i8 kernel != plain at m = 1000")
    small = dict(generator=g, device=dev)
    vb3 = torch.randint(-2, 3, (3, pab.D_PAD, TAIL_BUCKETS),
                        **small).bfloat16()
    vn3 = torch.randint(0, 9, (3, 1, TAIL_BUCKETS), **small).float()
    q3 = torch.randint(-2, 3, (256, pab.D_PAD), **small).bfloat16()
    qn3 = torch.randint(0, 9, (256, 1), **small).float()
    args3 = dict(m=TAIL_BUCKETS, bits=pab.id_bits(3, 1))
    ab_k = pab.probe_kernel_ab("full", vn3, vb3, q3, qn3, **args3)
    ab_p = pab.probe_kernel_ab_reference("full", vn3, vb3, q3, qn3, **args3)
    out["probe_max_abs_err"] = float((ab_k.double() - ab_p.double())
                                     .abs().max())
    if not torch.equal(ab_k, ab_p):
        raise AssertionError("A/B probe kernel != plain at m = 1000")
    print(f"[tail] m = {TAIL_BUCKETS}, {TAIL_Q} queries: bf16 and int8f "
          f"kernels within the tolerance of plain (max |score err| "
          f"{out['bfloat16']['max_abs_err']:.3g} / "
          f"{out['int8f']['max_abs_err']:.3g}, block-id ties "
          f"{out['bfloat16']['block_id_ties']:.2e} / "
          f"{out['int8f']['block_id_ties']:.2e}); i8 kernel scores and ids "
          f"bitwise equal; probe full bitwise equal on small integers; "
          f"launches while serving {out['launches']}")
    return out


class _FailAfter:
    """A row source that raises after ``n`` chunks: a build stopped
    mid-way, for the checkpointed ``from_store``."""

    def __init__(self, store, n):
        self._store, self._n = store, n

    def __len__(self):
        return len(self._store)

    def chunks(self, chunk_rows):
        for i, chunk in enumerate(self._store.chunks(chunk_rows)):
            if i >= self._n:
                raise RuntimeError("build stopped after chunk 2")
            yield chunk


def _same_chunks(a, b):
    """Two ``ChunkedIndex``es with equal chunks, array for array."""
    import numpy as np

    return a._offsets == b._offsets and all(
        all(np.array_equal(np.asarray(ca[key]), np.asarray(cb[key]))
            for key in ca) for ca, cb in zip(a._chunks, b._chunks))


def _ooc_small(dev, tmp):
    """Phase 10's small checks at SMALL_N x SMALL_D in 4 chunks: ``search``
    equal to ``exact_ball``; ``save`` -> ``load``, a ``spill_dir`` build
    and a checkpointed ``from_store`` stopped after chunk 2 and resumed,
    each serving the in-RAM index's answers bit for bit."""
    import numpy as np
    import torch

    from vector_database_tpu_torch import (
        ChunkedIndex,
        NativeVectorStore,
        exact_ball,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    v8 = torch.rand((SMALL_N, SMALL_D), generator=g, device=dev) * 2 - 1
    q8 = (torch.rand((SMALL_Q, SMALL_D), generator=g, device=dev) * 2 - 1)
    v8_host, q8_host = v8.cpu().numpy(), q8.cpu().numpy()
    index = ChunkedIndex(leaf_size=LEAF)
    for lo in range(0, SMALL_N, SMALL_CHUNK):
        index.add_chunk(v8_host[lo:lo + SMALL_CHUNK])
    radius = 0.35
    got = index.search(q8_host, radius)
    want = [set() for _ in range(SMALL_Q)]
    for lo in range(0, SMALL_N, SMALL_CHUNK):
        qi, ri = torch.nonzero(exact_ball(v8[lo:lo + SMALL_CHUNK], q8,
                                          radius), as_tuple=True)
        for a, b in zip(qi.tolist(), ri.tolist()):
            want[a].add(lo + b)
    for i in range(SMALL_Q):
        if set(got[i][0].tolist()) != want[i]:
            raise AssertionError(f"ChunkedIndex.search != exact_ball, "
                                 f"query {i}")
    matches = sum(len(w) for w in want)
    ref = index.knn(q8_host, K)

    def same(other, what):
        r, d = other.knn(q8_host, K)
        if not (np.array_equal(r, ref[0]) and np.array_equal(d, ref[1])):
            raise AssertionError(f"{what} serves other answers")

    index.save(os.path.join(tmp, "saved"))
    loaded = ChunkedIndex.load(os.path.join(tmp, "saved"))
    if not isinstance(loaded._chunks[0]["vb"], np.memmap):
        raise AssertionError("load did not memory-map the blocks")
    same(loaded, "save -> load")
    spilled = ChunkedIndex(leaf_size=LEAF, spill_dir=os.path.join(tmp, "sp"))
    for lo in range(0, SMALL_N, SMALL_CHUNK):
        spilled.add_chunk(v8_host[lo:lo + SMALL_CHUNK])
    if not (isinstance(spilled._chunks[0]["vectors"], np.memmap)
            and _same_chunks(spilled, index)):
        raise AssertionError("spill_dir build differs from the in-RAM one")
    same(spilled, "spill_dir")
    ck = os.path.join(tmp, "ck")
    with NativeVectorStore.create(os.path.join(tmp, "small.vstore"),
                                  dims=SMALL_D) as store:
        store.append(v8_host)
        try:
            ChunkedIndex.from_store(_FailAfter(store, 2), SMALL_CHUNK,
                                    leaf_size=LEAF, checkpoint_dir=ck)
            raise AssertionError("the stopped build did not stop")
        except RuntimeError as e:
            if "stopped after chunk 2" not in str(e):
                raise
        with open(os.path.join(ck, "resume.json")) as f:
            if json.load(f)["chunks_done"] != 2:
                raise AssertionError("the checkpoint did not keep 2 chunks")
        resumed = ChunkedIndex.from_store(store, SMALL_CHUNK, leaf_size=LEAF,
                                          checkpoint_dir=ck)
    if not _same_chunks(resumed, index):
        raise AssertionError("resumed build differs from an unbroken one")
    same(resumed, "resumed build")
    print(f"[ooc] {SMALL_N}x{SMALL_D} in {SMALL_N // SMALL_CHUNK} chunks: "
          f"search r={radius} on {SMALL_Q} queries == exact_ball ({matches} "
          f"matches); save -> load, spill_dir and a checkpointed build "
          f"stopped after chunk 2 then resumed: equal chunks, the same "
          f"answers bit for bit")
    return dict(search_matches=matches)


def _ooc_phase(dev, main_kernel_ms):
    """Phase 10: ``ChunkedIndex`` over a ``NativeVectorStore`` of OOC_N x
    D rows in chunks of OOC_CHUNK (block 8192, 4096 buckets, d_pad 96):
    the store write and build, streamed, pinned pipelined and sequential
    serving (full and pruned), the device rerank, recall against an exact
    oracle over all rows, the host rerank alone, then the scan kernel
    alone at one pinned chunk's shape; then the small checks."""
    import tempfile

    import numpy as np
    import torch

    from vector_database_tpu_torch import (
        ChunkedIndex,
        NativeVectorStore,
        exact_knn,
    )
    from vector_database_tpu_torch.ops import bucket_scan as bs
    from vector_database_tpu_torch.ops.packed_knn import (
        _block_map,
        pallas_scan_knn_candidates,
    )
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    out = {}
    chunks = OOC_N // OOC_CHUNK
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="chip_smoke_") as tmp:
        g = torch.Generator(device=dev).manual_seed(SEED + 10)
        n_centers = OOC_N // 1000
        centers = torch.rand((n_centers, D), generator=g, device=dev) * 2 - 1
        test = _fresh(centers, Q, g)
        q_host = test.cpu().numpy()
        t0 = time.perf_counter()
        store = NativeVectorStore.create(os.path.join(tmp, "rows.vstore"),
                                         dims=D, capacity_rows=OOC_N)
        for i in range(chunks):
            gi = torch.Generator(device=dev).manual_seed(SEED + 11 + i)
            rows = centers[torch.randint(0, n_centers, (OOC_CHUNK,),
                                         generator=gi, device=dev)]
            rows += 0.05 * torch.randn((OOC_CHUNK, D), generator=gi,
                                       device=dev)
            store.append(rows.cpu().numpy())
            del rows
        out["store_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx = ChunkedIndex.from_store(store, chunk_rows=OOC_CHUNK,
                                      leaf_size=LEAF)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        c0 = idx._chunks[0]
        nb, d_pad = c0["vb"].shape[0], c0["vb"].shape[1]
        print(f"[ooc] store of {OOC_N}x{D} written in "
              f"{out['store_write_s']:.3f} s; from_store in {chunks} chunks "
              f"of {OOC_CHUNK}: {out['build_s']:.3f} s; nb={nb} d_pad="
              f"{d_pad} bits={c0['bits']}")
        if idx.num_chunks != chunks or len(idx) != OOC_N or d_pad != 96:
            raise AssertionError(f"{idx.num_chunks} chunks, d_pad {d_pad}")

        # the exact oracle over all rows, chunk by chunk on the card
        cat_i = cat_d = None
        for i in range(chunks):
            part = torch.as_tensor(store.rows(i * OOC_CHUNK, OOC_CHUNK),
                                   device=dev)
            pi, pd = exact_knn(part, test[:TRUTH_Q], k=K)
            pi = pi + i * OOC_CHUNK
            cat_i = pi if cat_i is None else torch.cat([cat_i, pi], 1)
            cat_d = pd if cat_d is None else torch.cat([cat_d, pd], 1)
            del part
        o = torch.argsort(cat_d, dim=1, stable=True)[:, :K]
        truth = cat_i.gather(1, o)

        env = os.environ.get("VDB_PIN_PIPELINE")
        torch.cuda.synchronize()
        COUNTERS["scan.launches.bf16"] = 0
        results = {}

        def run(name, reps=REPS, **kw):
            got = idx.knn(q_host, K, **kw)
            ms = _host_ms(lambda: idx.knn(q_host, K, **kw), reps)
            rec = _recall(torch.as_tensor(got[0][:TRUTH_Q]), truth)
            results[name] = got
            out[f"{name}_ms"], out[f"{name}_qps"] = ms, Q / ms * 1e3
            out[f"{name}_recall"] = rec
            print(f"[ooc] {name} q={Q}: {ms:.3f} ms, {Q / ms * 1e3:.1f} "
                  f"QPS, recall@{K} {rec:.4f}")

        run("streamed")
        t0 = time.perf_counter()
        idx.pin()
        torch.cuda.synchronize()
        out["pin_s"] = time.perf_counter() - t0
        for flag, name in (("1", "pinned"), ("0", "pinned_seq")):
            os.environ["VDB_PIN_PIPELINE"] = flag
            run(name)
            run(f"{name}_pruned{OOC_PROBES}", probes=OOC_PROBES)
        if env is None:
            os.environ.pop("VDB_PIN_PIPELINE")
        else:
            os.environ["VDB_PIN_PIPELINE"] = env
        run("pinned_device_rerank", host_rerank=False)
        torch.cuda.synchronize()
        out["launches"] = COUNTERS["scan.launches.bf16"]
        if out["launches"] < 1:
            raise AssertionError("the chunk path never launched bucket_scan")
        for a, b in (("pinned", "pinned_seq"), ("streamed", "pinned"),
                     (f"pinned_pruned{OOC_PROBES}",
                      f"pinned_seq_pruned{OOC_PROBES}")):
            if not all(np.array_equal(x, y)
                       for x, y in zip(results[a], results[b])):
                raise AssertionError(f"{a} != {b}")
        hr, hd = results["pinned"]
        dr, dd = results["pinned_device_rerank"]
        out["device_rerank_ties"] = _check_knn(dr, dd, hr, hd,
                                               "knn(host_rerank=False)")
        # the CPU tests' tolerance for the two reranks (f32 sums of the
        # same differences in other orders)
        np.testing.assert_allclose(dd, hd, rtol=1e-4, atol=1e-5)
        for name in ("streamed", "pinned", "pinned_device_rerank"):
            if out[f"{name}_recall"] < 0.98:
                raise AssertionError(f"{name} recall@{K} "
                                     f"{out[name + '_recall']} < 0.98")
        print(f"[ooc] pin {out['pin_s']:.3f} s; pinned pipelined == "
              f"sequential (full and pruned {OOC_PROBES}) and streamed == "
              f"pinned, bitwise; the device rerank's ids == the host "
              f"rerank's ({out['device_rerank_ties']} ties at the k-th); "
              f"bucket_scan launches {out['launches']}")

        # where a pinned batch's time goes: a chunk's scan + shortlist on
        # the card, and its host rerank alone
        pack = idx._device_pack(idx._pinned[0], c0,
                                vectors=torch.empty((0, D), device=dev))
        out["shortlist_ms_per_chunk"] = _ms(
            lambda: pallas_scan_knn_candidates(pack, test, k=K), REPS)
        short = pallas_scan_knn_candidates(pack, test, k=K).cpu().numpy()
        out["host_rerank_ms_per_chunk"] = _host_ms(
            lambda: idx._host_rerank(c0, short, q_host, K), REPS)
        print(f"[ooc] per chunk: scan + shortlist on the card "
              f"{out['shortlist_ms_per_chunk']:.3f} ms, host rerank "
              f"{out['host_rerank_ms_per_chunk']:.3f} ms")

        # the kernel alone at one pinned chunk's shape, full and pruned
        vb, vn = idx._pinned[0]
        qb = torch.zeros((Q, d_pad), device=dev)
        qb[:, :D] = test
        qb = qb.bfloat16()
        args = dict(m=pack.m, bits=pack.bits)
        acc_k = bs.bucket_scan(vn, vb, qb, **args)
        acc_p = bs.bucket_scan_reference(vn, vb, qb, **args)
        err, mis = _compare_acc(acc_k, acc_p, pack, qb)
        k_ms = _ms(lambda: bs.bucket_scan(vn, vb, qb, **args), REPS)
        p_ms = _ms(lambda: bs.bucket_scan_reference(vn, vb, qb, **args),
                   REPS)
        block_bytes = d_pad * pack.block * 2 + pack.block * 4
        kern = _numbers(k_ms, 2 * Q * nb * pack.block * d_pad,
                        nb * block_bytes + _nbytes(qb, acc_k), PEAK_BF16,
                        _matmul_ms(qb, vb, nb))
        pack.cent = torch.as_tensor(c0["cent"], device=dev)
        pack.rad = torch.as_tensor(c0["rad"], device=dev)
        order, bmap = _block_map(pack, test, q_tile=512, probes=OOC_PROBES)
        qs = qb[order]
        pargs = dict(args, bmap=bmap, nprobe=OOC_PROBES, q_tile=512)
        perr, _ = _compare_acc(bs.bucket_scan(vn, vb, qs, **pargs),
                               bs.bucket_scan_reference(vn, vb, qs, **pargs),
                               pack, qs)
        pk_ms = _ms(lambda: bs.bucket_scan(vn, vb, qs, **pargs), REPS)
        pp_ms = _ms(lambda: bs.bucket_scan_reference(vn, vb, qs, **pargs),
                    REPS)
        # every query streams OOC_PROBES blocks; the blocks some group
        # reads cross HBM once
        read = torch.unique(bmap[:, :OOC_PROBES]).numel()
        pkern = _numbers(pk_ms, 2 * Q * OOC_PROBES * pack.block * d_pad,
                         read * block_bytes + _nbytes(qs, acc_k), PEAK_BF16,
                         _matmul_ms(qb, vb, OOC_PROBES))
        out["kernel"] = dict(kern, max_abs_err=err, block_id_ties=mis,
                             plain_ms=p_ms, pruned256_ms=pk_ms,
                             pruned256_max_abs_err=perr,
                             pruned256_plain_ms=pp_ms,
                             pruned256_bound_ms=pkern["bound_ms"],
                             pruned256_bound_by=pkern["bound_by"],
                             pruned256_library_ms=pkern["library_ms"],
                             nb=nb, d_pad=d_pad)
        print(f"[ooc] kernel at a chunk's shape ({Q}x{nb} blocks, d_pad "
              f"{d_pad}): {k_ms:.3f} ms (the main path's d_pad 128: "
              f"{main_kernel_ms:.3f} ms), plain {p_ms:.3f} ms, max |score "
              f"err| {err:.3g}, block-id ties {mis:.2e}; bound "
              f"{kern['bound_ms']:.3f} ms ({kern['bound_by']}), "
              f"{kern['pct_of_bound']:.1f}% of bound; torch.matmul "
              f"{kern['library_ms']:.3f} ms; pruned {OOC_PROBES} "
              f"{pk_ms:.3f} ms, plain {pp_ms:.3f} ms, max |score err| "
              f"{perr:.3g}, bound {pkern['bound_ms']:.3f} ms "
              f"({pkern['bound_by']}), {pkern['pct_of_bound']:.1f}% of "
              f"bound; torch.matmul {pkern['library_ms']:.3f} ms")
        del acc_k, acc_p, pack, vb, vn
        idx.unpin()
        store.close()
        del idx, store
        torch.cuda.empty_cache()
        out["small"] = _ooc_small(dev, tmp)
    return out


def _models_phase(dev):
    """Phase 11: ``MemoryVectorIndex`` of MODEL_N seeded records (find,
    find_batch, to_bsp with search and locate, remove),
    ``BoolMatrixIndex`` of MODEL_N x BOOL_P (identify_batch, knn_hamming,
    find_hamming) and the heap-row round trip of a leaf_size=1 tree."""
    import numpy as np
    import torch

    from vector_database_tpu_torch import (
        BoolMatrixIndex,
        BSPIndex,
        MemoryVectorIndex,
        build_index_fused,
        locate,
        search,
    )

    out = {}
    rng = np.random.default_rng(SEED + 20)
    recs = rng.random((MODEL_N, MODEL_D), np.float32) * 2 - 1
    t0 = time.perf_counter()
    mem = MemoryVectorIndex([(i, recs[i]) for i in range(MODEL_N)],
                            vector_selector=lambda r: r[1])
    out["memindex_build_s"] = time.perf_counter() - t0
    qs = recs[:MODEL_Q] + 0.01
    radius = 0.6
    d2 = ((qs[:, None, :] - recs[None]) ** 2).sum(-1)
    want = [set(np.nonzero(row <= radius * radius)[0].tolist()) for row in d2]
    for i in range(MODEL_Q):
        if {r[0] for r in mem.find(qs[i], radius)} != want[i]:
            raise AssertionError(f"MemoryVectorIndex.find != oracle, {i}")
    records, match = mem.find_batch(qs, radius)
    ids = np.array([r[0] for r in records])
    if [set(ids[m].tolist()) for m in match] != want:
        raise AssertionError("MemoryVectorIndex.find_batch != oracle")
    t0 = time.perf_counter()
    bsp, records = mem.to_bsp()
    out["to_bsp_s"] = time.perf_counter() - t0
    ids = np.array([r[0] for r in records])
    res = search(bsp, qs, radius)
    if [set(ids[res.match_rows(i)].tolist()) for i in range(MODEL_Q)] != want:
        raise AssertionError("to_bsp search != oracle")
    n_loc = min(4096, len(records))
    rows = locate(bsp, np.stack([r[1] for r in records[:n_loc]])).cpu()
    if not torch.equal(rows, torch.arange(n_loc)):
        raise AssertionError("locate on the trie export missed a record")
    removed = mem.remove(qs[0], radius)
    if removed != len(want[0]) or list(mem.find(qs[0], radius)) or \
            len(mem) != MODEL_N - removed:
        raise AssertionError("MemoryVectorIndex.remove")
    matches = sum(len(w) for w in want)
    print(f"[models] MemoryVectorIndex of {MODEL_N} records in [-1, 1]^"
          f"{MODEL_D}: built in {out['memindex_build_s']:.3f} s; find and "
          f"find_batch r={radius} == oracle ({matches} matches); to_bsp "
          f"{out['to_bsp_s']:.3f} s, search == oracle, locate of {n_loc} "
          f"records exact; remove of {removed} then find: none")

    bits = rng.random((MODEL_N, BOOL_P)) < 0.5
    t0 = time.perf_counter()
    bm = BoolMatrixIndex(bits, leaf_size=8)
    torch.cuda.synchronize()
    out["boolmatrix_build_s"] = time.perf_counter() - t0
    sel = rng.choice(MODEL_N, BOOL_Q, replace=False)
    if not np.array_equal(bm.identify_batch(bits[sel]).cpu().numpy(), sel):
        raise AssertionError("identify_batch did not return each row")
    signed = bits.astype(np.float32) * 2 - 1
    ham = ((BOOL_P - signed[sel[:MODEL_Q]] @ signed.T) / 2).astype(np.int32)
    rows, dist = bm.knn_hamming(bits[sel[:MODEL_Q]], k=K)
    true = np.take_along_axis(ham, rows, 1)
    if not (np.array_equal(true, dist)
            and np.array_equal(dist, np.sort(ham, 1)[:, :K])):
        raise AssertionError("knn_hamming != oracle")
    max_dist = 16
    found = bm.find_hamming(bits[sel[:MODEL_Q]], max_dist)
    for i, (r, dd) in enumerate(found):
        if set(r.tolist()) != set(np.nonzero(ham[i] <= max_dist)[0].tolist()) \
                or not np.array_equal(ham[i][r], dd):
            raise AssertionError(f"find_hamming != oracle, query {i}")
    print(f"[models] BoolMatrixIndex {MODEL_N}x{BOOL_P}: built in "
          f"{out['boolmatrix_build_s']:.3f} s; identify_batch of {BOOL_Q} "
          f"stored rows returns each row; knn_hamming and find_hamming "
          f"(<= {max_dist}: {sum(len(r) for r, _ in found)} rows) == oracle")

    tree = build_index_fused(recs, leaf_size=1)
    heap = list(tree.heap_rows())
    back = list(BSPIndex.from_heap_rows(heap, recs).heap_rows())
    if back != heap:
        raise AssertionError("heap_rows -> from_heap_rows round trip")
    out["heap_rows"] = len(heap)
    print(f"[models] heap_rows -> from_heap_rows -> heap_rows on a "
          f"leaf_size=1 tree of {MODEL_N}x{MODEL_D}: {len(heap)} rows, "
          f"equal")
    return out


def _same_sharded_tree(sharded, fused):
    """A world-of-one ``ShardedBSPIndex`` equal to a ``BSPIndex`` field by
    field, bit for bit (its rank holds every row)."""
    return _same_tree(sharded, fused) and sharded.leaf_cap == \
        fused.leaf_cap and _same_bits(sharded.vectors, fused.vectors)


def _same_bits(a, b):
    """Two f32 tensors equal bit for bit."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _mesh_phase(dev, single_qps):
    """Phase 12: the multi-device layer on ``make_mesh()``, a world of one
    rank over NCCL. The sharded build of the 10M x D rows against the
    fused build (field by field), ``to_bsp``; the sharded pack and scan
    (full, static and runtime pruned 256) against the single-device scan
    on the same rows (ids through ``orig_row``, distances bitwise);
    ``PackedServer`` over the sharded pack (QPS, recall@10) beside the
    single-device server; the bf16 kernel's launches during the sharded
    serve; then the tree paths at TREE_N x TREE_D against the oracles:
    ``search_global``/``knn_global``, the forest, the query-sharded
    search and the one-slice multislice index."""
    import torch
    import torch.distributed as dist

    from vector_database_tpu_torch import (
        PackedServer,
        build_index_fused,
        exact_ball,
        exact_knn,
        pack_database,
        pallas_scan_knn_packed,
        pallas_scan_knn_packed_rt,
    )
    from vector_database_tpu_torch import parallel as par
    from vector_database_tpu_torch.search import calibrate_radius
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    out = {}
    t0 = time.perf_counter()
    mesh = par.make_mesh()
    out["mesh_s"] = time.perf_counter() - t0
    out["backend"] = dist.get_backend()
    out["world_size"] = dist.get_world_size()
    if out["backend"] != "nccl" or out["world_size"] != 1:
        raise AssertionError(f"mesh on {out['backend']}, world "
                             f"{out['world_size']}")

    train, test, _, _ = _clustered(dev, N, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = build_index_fused(train, leaf_size=LEAF)
    torch.cuda.synchronize()
    out["fused_build_s"] = time.perf_counter() - t0
    # the first sharded build carries NCCL's communicator setup (made at
    # the first collective); the second is the build alone
    for key in ("sharded_build_s", "sharded_build_again_s"):
        t0 = time.perf_counter()
        sharded = par.build_index_sharded(train, mesh, leaf_size=LEAF)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        if not _same_sharded_tree(sharded, fused):
            raise AssertionError("sharded build != fused build")
    del train
    out["fused_build_vps"] = N / out["fused_build_s"]
    out["sharded_build_vps"] = N / out["sharded_build_again_s"]
    # to_bsp relays the leaves in node order: each leaf's run is the fused
    # tree's run of that leaf, row for row
    bsp = par.to_bsp(sharded)
    leaves = torch.nonzero(fused.dim == -1)[:, 0]
    cnt = fused.leaf_count[leaves].long()
    src = torch.repeat_interleave(
        fused.leaf_start[leaves].long() - bsp.leaf_start[leaves].long(), cnt,
    ) + torch.arange(N, device=dev)
    if not (torch.equal(bsp.leaf_count, fused.leaf_count)
            and torch.equal(bsp.dim, fused.dim)
            and _same_bits(bsp.mid, fused.mid)
            and _same_bits(bsp.vectors, fused.vectors[src])
            and torch.equal(bsp.orig_row, fused.orig_row[src])):
        raise AssertionError("to_bsp != the fused tree")
    del bsp, src, sharded
    print(f"[mesh] make_mesh(): {out['backend']}, world size "
          f"{out['world_size']}; {N}x{D} leaf {LEAF}: fused build "
          f"{out['fused_build_s']:.3f} s ({out['fused_build_vps']:.1f} "
          f"vectors/s), sharded build {out['sharded_build_s']:.3f} s "
          f"(the first collective sets NCCL up), again "
          f"{out['sharded_build_again_s']:.3f} s "
          f"({out['sharded_build_vps']:.1f} vectors/s); both: node table, "
          f"leaf runs, rows and orig_row equal bit for bit; to_bsp the same "
          f"tree")

    t0 = time.perf_counter()
    pack = pack_database(fused.vectors, buckets=BUCKETS)
    torch.cuda.synchronize()
    out["pack_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sdb = par.pack_database_sharded(fused.vectors, mesh, buckets=BUCKETS,
                                    orig_rows=fused.orig_row)
    torch.cuda.synchronize()
    out["sharded_pack_s"] = time.perf_counter() - t0
    if not (torch.equal(sdb.vb, pack.vb) and torch.equal(sdb.vn, pack.vn)):
        raise AssertionError("sharded pack blocks != pack_database's")
    nb = sdb.vb.shape[0]
    q_tile, pmax = 512, max(PROBES)
    truth = fused.orig_row[exact_knn(fused.vectors, test[:TRUTH_Q],
                                     k=K)[0]]

    # the sharded serve: the launch count covers these calls only
    torch.cuda.synchronize()
    COUNTERS["scan.launches.bf16"] = 0
    got = {
        "full": par.sharded_scan_knn(sdb, test, k=K, q_tile=q_tile),
        "static256": par.sharded_scan_knn(sdb, test, k=K, q_tile=q_tile,
                                          probes=256),
        "runtime256": par.sharded_scan_knn(sdb, test, k=K, q_tile=q_tile,
                                           probes=256, probes_max=pmax),
    }
    srv = PackedServer(sdb, k=K, batch=Q)
    srv.warmup()
    ms = _ms(lambda: srv.query(test), REPS)
    rec = _recall(srv.query(test)[0][:TRUTH_Q], truth)
    out.update(sharded_full_ms=ms, sharded_full_qps=Q / ms * 1e3,
               sharded_full_recall=rec)
    psrv = PackedServer(sdb, k=K, batch=Q, probes=256, probes_max=pmax)
    psrv.warmup()
    ms = _ms(lambda: psrv.query(test), REPS)
    out.update(sharded_probes256_ms=ms, sharded_probes256_qps=Q / ms * 1e3,
               sharded_probes256_recall=_recall(
                   psrv.query(test)[0][:TRUTH_Q], truth))
    torch.cuda.synchronize()
    out["launches"] = COUNTERS["scan.launches.bf16"]
    if out["launches"] < 1:
        raise AssertionError("the sharded serve never launched bucket_scan")
    if rec < 0.98:
        raise AssertionError(f"sharded full-scan recall@{K} {rec} < 0.98")

    # the single-device path on the same rows, rows mapped through orig_row
    want = {
        "full": pallas_scan_knn_packed(pack, test, k=K, q_tile=q_tile),
        "static256": pallas_scan_knn_packed(pack, test, k=K, q_tile=q_tile,
                                            probes=256),
        "runtime256": pallas_scan_knn_packed_rt(pack, test, 256, k=K,
                                                probes_max=pmax,
                                                q_tile=q_tile),
    }
    for name, (r, d) in want.items():
        gr, gd = got[name]
        r = torch.where(r >= 0, fused.orig_row[r.clamp(min=0)].long(), -1)
        if not (torch.equal(gr, r) and _same_bits(gd, d)):
            raise AssertionError(f"sharded {name} scan != single-device")
    if not all(torch.equal(a, b) for a, b in zip(got["runtime256"],
                                                 got["static256"])):
        raise AssertionError("sharded runtime probes != static probes")
    one = PackedServer(pack, k=K, batch=Q)
    one.warmup()
    ms = _ms(lambda: one.query(test), REPS)
    out.update(single_full_ms=ms, single_full_qps=Q / ms * 1e3,
               main_path_full_qps=single_qps)
    print(f"[mesh] pack_database_sharded {out['sharded_pack_s']:.3f} s "
          f"(pack_database {out['pack_s']:.3f} s), blocks equal; "
          f"sharded_scan_knn q={Q} full, static and runtime pruned 256 == "
          f"the single-device scan (ids through orig_row, distances "
          f"bitwise); PackedServer over the sharded pack: full "
          f"{out['sharded_full_ms']:.3f} ms, {out['sharded_full_qps']:.1f} "
          f"QPS, recall@{K} {rec:.4f}; pruned 256 "
          f"{out['sharded_probes256_ms']:.3f} ms, "
          f"{out['sharded_probes256_qps']:.1f} QPS, recall@{K} "
          f"{out['sharded_probes256_recall']:.4f}; single-device server "
          f"here {out['single_full_ms']:.3f} ms, {out['single_full_qps']:.1f}"
          f" QPS (phase 3: {single_qps:.1f} QPS); bucket_scan launches in "
          f"the sharded serve {out['launches']}")
    del srv, psrv, one, pack, sdb, got, want, fused, test, truth
    torch.cuda.empty_cache()

    # the tree paths at phase 5's size, each against the oracle
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    v8 = torch.rand((TREE_N, TREE_D), generator=g, device=dev) * 2 - 1
    q8 = torch.rand((64, TREE_D), generator=g, device=dev) * 2 - 1
    radius = calibrate_radius(v8, q8, K, 0.95)
    ball = exact_ball(v8, q8, radius)
    erows, ed2 = exact_knn(v8, q8, k=K)
    want_ball = [set(torch.nonzero(ball[i])[:, 0].tolist())
                 for i in range(q8.shape[0])]

    def check_ball(rows, what):
        for i, w in enumerate(want_ball):
            r = rows[i]
            if set(r[r >= 0].tolist()) != w:
                raise AssertionError(f"{what} != exact_ball, query {i}")

    def check_knn(rows, d2, what):
        full = torch.isfinite(d2).all(dim=1)
        for i in torch.nonzero(full)[:, 0].tolist():
            if set(rows[i].tolist()) != set(erows[i].tolist()):
                raise AssertionError(f"{what} != exact_knn, query {i}")
        return int(full.sum())

    t0 = time.perf_counter()
    t8 = par.build_index_sharded(v8, mesh, leaf_size=16)
    torch.cuda.synchronize()
    out["tree_sharded_build_s"] = time.perf_counter() - t0
    tree = build_index_fused(v8, leaf_size=16)
    # in 8 dimensions a ball of this radius meets most leaves, and the
    # sharded paths keep JAX's fixed leaf buffer (no auto-grow): a buffer
    # of every leaf cannot overflow
    ml = tree.num_leaves
    _, _, _, ov = res = par.search_global(t8, q8, radius, max_leaves=ml)
    if bool(ov.any()):
        raise AssertionError("search_global overflowed every leaf")
    check_ball(res[0], "search_global")
    full = check_knn(*par.knn_global(t8, q8, K, radius, max_leaves=ml),
                     "knn_global")
    fo = par.build_forest(v8, mesh, leaf_size=16)
    check_knn(*par.forest_knn(fo, q8, K, radius, max_leaves=ml)[:2],
              "forest_knn")
    check_ball(par.search_sharded(tree, q8, radius, mesh).rows,
               "search_sharded")
    check_knn(*par.knn_sharded(tree, q8, K, radius, mesh), "knn_sharded")
    ms1 = par.build_index_multislice(v8, n_slices=1, leaf_size=16)
    check_knn(*par.knn_multislice(ms1, q8, K, radius, max_leaves=ml),
              "knn_multislice")
    check_ball(par.search_multislice(ms1, q8, radius, max_leaves=ml)[0],
               "search_multislice")
    print(f"[mesh] {TREE_N}x{TREE_D}: sharded build "
          f"{out['tree_sharded_build_s']:.3f} s; search_global, "
          f"search_sharded, search_multislice == exact_ball; knn_global, "
          f"forest_knn, knn_sharded, knn_multislice == exact_knn on {full} "
          f"full rows")
    del v8, q8, t8, fo, tree, ms1, ball, res
    return out


def _hostloop_phase(dev, fused_build_s):
    """Phase 13: the host-loop build at N x D (twice, one tree; per-level
    times from ``BuildStats``), its pack served by ``PackedServer`` with
    the ``bucket_scan`` launches counted, the world-size-1 mesh forms
    (rows, and rows with ``dim_axis``) against the single-device tree,
    the one-hot reference shape against the fused build, and the entry
    twin's forward against the oracle. Destroys the process group of
    phases 12-13 at the end."""
    import torch
    import torch.distributed as dist

    from vector_database_tpu_torch import (
        PackedServer,
        build_index,
        build_index_fused,
        exact_ball,
        exact_knn,
        pack_database,
    )
    from vector_database_tpu_torch import entry as twin
    from vector_database_tpu_torch import parallel as par
    from vector_database_tpu_torch.builder import _level_to_host
    from vector_database_tpu_torch.utils import datasets
    from vector_database_tpu_torch.utils.profiling import BuildStats, COUNTERS

    t_phase = time.perf_counter()
    out = dict(fused_build_s_phase3=fused_build_s)
    train, test, _, _ = _clustered(dev, N, SEED)
    torch.cuda.synchronize()

    # the main path of this phase: build, pack, serve; the launch count
    # covers it alone
    COUNTERS["scan.launches.bf16"] = 0
    trees, stats = [], []
    for key in ("build_s", "build_again_s"):
        stats.append(BuildStats())
        t0 = time.perf_counter()
        trees.append(build_index(train, leaf_size=LEAF, progress=stats[-1]))
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    index = trees[0]
    if not (_same_tree(*trees) and _same_bits(trees[0].vectors,
                                              trees[1].vectors)):
        raise AssertionError("two host-loop builds of one input gave two "
                             "trees")
    del trees
    levels = stats[1].levels
    out.update(depth=index.depth, leaves=index.num_leaves,
               leaf_cap=index.leaf_cap, build_vps=N / out["build_again_s"],
               level_s=[s.seconds for s in levels],
               level_live=[s.live_ranges for s in levels])
    print(f"[host_loop] build_index {N}x{D} leaf {LEAF}: "
          f"{out['build_s']:.3f} s, again {out['build_again_s']:.3f} s "
          f"({out['build_vps']:.1f} vectors/s; phase 3's fused build "
          f"{fused_build_s:.3f} s); the two indexes equal field by field; "
          f"depth {index.depth}, {index.num_leaves} leaves, leaf cap "
          f"{index.leaf_cap}")
    print("[host_loop] per level (BuildStats, the second build):\n"
          + stats[1].report())

    t0 = time.perf_counter()
    pack = pack_database(index.vectors, buckets=BUCKETS)
    torch.cuda.synchronize()
    out["pack_s"] = time.perf_counter() - t0
    truth = exact_knn(index.vectors, test[:TRUTH_Q], k=K)[0]
    srv = PackedServer(pack, k=K, batch=Q)
    srv.warmup()
    ms = _ms(lambda: srv.query(test), REPS)
    rec = _recall(srv.query(test)[0][:TRUTH_Q], truth)
    torch.cuda.synchronize()
    out.update(full_ms=ms, full_qps=Q / ms * 1e3, full_recall=rec,
               launches=COUNTERS["scan.launches.bf16"])
    print(f"[host_loop] pack {out['pack_s']:.3f} s; PackedServer full scan "
          f"q={Q}: {ms:.3f} ms, {out['full_qps']:.1f} QPS, recall@{K} "
          f"{rec:.4f}; bucket_scan launches {out['launches']}")
    if out["launches"] < 1:
        raise AssertionError("the host-loop tree's serve never launched "
                             "bucket_scan")
    if rec < 0.98:
        raise AssertionError(f"host-loop full-scan recall@{K} {rec} < 0.98")
    del srv, pack, truth

    # the level's one device-to-host copy, alone, at the widest level
    s_max = max(s.live_ranges for s in levels)
    fake = dict(cnt=torch.ones(s_max, dtype=torch.int32, device=dev),
                split_dim=torch.ones(s_max, dtype=torch.int32, device=dev),
                mid=torch.ones(s_max, device=dev),
                dual=torch.zeros(s_max, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    out["host_copy_ms"] = _host_ms(lambda: _level_to_host(fake, s_max), REPS)
    out["host_copy_segments"] = s_max
    print(f"[host_loop] the per-level host copy alone at {s_max} segments "
          f"(the widest level): {out['host_copy_ms']:.3f} ms")
    del fake

    # the mesh forms at world size 1 over NCCL, at the full N x D
    mesh = par.make_mesh()
    mesh2 = par.make_mesh_2d(1, 1)
    for key, kw in (("mesh_build_s", dict(mesh=mesh)),
                    ("mesh_dim_axis_build_s", dict(mesh=mesh2,
                                                   dim_axis="model"))):
        t0 = time.perf_counter()
        got = build_index(train, leaf_size=LEAF, **kw)
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        if not (_same_tree(got, index) and got.leaf_cap == index.leaf_cap
                and _same_bits(got.vectors, index.vectors)):
            raise AssertionError(f"{key[:-2]} at world size 1 != the "
                                 f"single-device host-loop tree")
        del got
    print(f"[host_loop] world size 1 over {dist.get_backend()} at "
          f"{N}x{D}: build_index(mesh=make_mesh()) "
          f"{out['mesh_build_s']:.3f} s, build_index(mesh=make_mesh_2d(1, "
          f"1), dim_axis='model') {out['mesh_dim_axis_build_s']:.3f} s; "
          f"both equal the single-device tree bit for bit")
    del train, test, index
    torch.cuda.empty_cache()

    # the reference's adversarial shape: the fused build's tree
    # (tests/test_fused.py: equal structure, planes within rtol 1e-4 and
    # atol 1e-6, each leaf's rows as a set)
    oh = torch.as_tensor(datasets.one_hot_crafted(1536), device=dev)
    a, b = build_index(oh), build_index_fused(oh)
    for f in ("dim", "low", "high", "leaf_count"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"one-hot: host-loop {f} != fused")
    if not torch.allclose(a.mid, b.mid, rtol=1e-4, atol=1e-6) or \
            (a.depth, a.leaf_cap, a.num_leaves) != \
            (b.depth, b.leaf_cap, b.num_leaves):
        raise AssertionError("one-hot: host-loop tree != fused tree")
    for m in torch.nonzero(a.dim == -1)[:, 0].tolist():
        c = int(a.leaf_count[m])
        ra = a.orig_row[int(a.leaf_start[m]):][:c].tolist()
        rb = b.orig_row[int(b.leaf_start[m]):][:c].tolist()
        if set(ra) != set(rb):
            raise AssertionError(f"one-hot: leaf {m} holds other rows")
    print(f"[host_loop] one_hot_crafted(1536): build_index == "
          f"build_index_fused (depth {a.depth}, {a.num_leaves} leaves)")
    del oh, a, b

    # the ``__graft_entry__.py`` twin on the card
    forward, (queries,) = twin.entry()
    frows, _ = forward(queries)
    out["entry_ms"] = _host_ms(lambda: forward(queries), REPS)
    v = torch.as_tensor(datasets.random_uniform(4096, 32, seed=0),
                        device=dev)
    full = exact_ball(v, queries, twin.RADIUS).sum(dim=1) >= twin.K
    erows = exact_knn(v, queries, k=twin.K)[0]
    for i in torch.nonzero(full)[:, 0].tolist():
        if set(frows[i].tolist()) != set(erows[i].tolist()):
            raise AssertionError(f"entry forward != exact_knn, query {i}")
    out["entry_exact_queries"] = int(full.sum())
    if not (frows.is_cuda and out["entry_exact_queries"] > 0):
        raise AssertionError("entry forward off the card, or no query "
                             "whose ball holds k rows")
    print(f"[host_loop] entry(): forward {tuple(frows.shape)} on "
          f"{frows.device}, {out['entry_ms']:.3f} ms; == exact_knn on the "
          f"{out['entry_exact_queries']} queries whose ball holds "
          f"{twin.K} rows")
    del forward, queries, frows, v, full, erows, mesh, mesh2
    dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[host_loop] phase 13 took {out['phase_s']:.1f} s")
    return out


def _run_harness(name, argv):
    """``main(argv)`` of ``vector_database_tpu_torch.benchmarks.<name>``,
    in this process: ``(JSON lines, return value, seconds)``. Its output
    is kept, and printed if it raises (the error goes on up)."""
    import contextlib
    import importlib
    import io

    import torch

    mod = importlib.import_module(
        f"vector_database_tpu_torch.benchmarks.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = mod.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(f"[harness] {name} {' '.join(argv)} failed; its output:\n"
              + buf.getvalue())
        raise
    secs = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    print(f"[harness] {name} {' '.join(argv)}: {secs:.2f} s, "
          f"{len(lines)} JSON lines")
    return lines, ret, secs


def _harness_phase(dev):
    """Phase 14: each measurement harness of
    ``vector_database_tpu_torch/benchmarks/`` through its ``main(argv)``
    on the card at a reduced size, its promises asserted; the scan
    kernels' launches counted over the phase."""
    import torch

    from vector_database_tpu_torch.utils.profiling import COUNTERS

    t_phase = time.perf_counter()
    n, chunk = str(HARNESS_N), str(HARNESS_N // 2)
    tmp = os.path.join("build", f"chip_smoke_harness_{os.getpid()}")
    out, secs = {}, {}
    COUNTERS["scan.launches.bf16"] = COUNTERS["scan.launches.int8f"] = 0
    COUNTERS["scan.launches.int8"] = 0

    def run(name, *argv):
        lines, ret, t = _run_harness(name, list(argv))
        secs[name] = secs.get(name, 0.0) + t
        torch.cuda.empty_cache()
        return lines, ret

    # recall/QPS at 1M: full, pruned, the buckets x oversample sweep, the
    # world-size-1 mesh and the tree walk
    lines, rep = run("recall_qps", "--n", n, "--reps", "3", "--probes",
                     "64,128", "--sweep", "--sharded")
    probes = {x["probes"]["probes"]: x["probes"]["recall"]
              for x in lines if "probes" in x}
    sharded = {x["sharded_probes"]["probes"]: x["sharded_probes"]["recall"]
               for x in lines if "sharded_probes" in x}
    sweep = [x["sweep"] for x in lines if "sweep" in x]
    out["recall_qps"] = dict(
        {k: rep[k] for k in ("build_s", "pallas_qps", "pallas_recall",
                             "scan_bf16_qps", "scan_bf16_recall",
                             "sharded_qps", "sharded_recall", "tree_qps",
                             "tree_recall")},
        probes_recall=probes, sweep_points=len(sweep))
    if rep["pallas_recall"] < 0.98:
        raise AssertionError(f"recall_qps: packed recall@10 "
                             f"{rep['pallas_recall']} < 0.98")
    if rep["sharded_recall"] != rep["pallas_recall"] or sharded != probes:
        raise AssertionError("recall_qps: the sharded recall != the "
                             "single-device recall")
    if len(sweep) != 9:
        raise AssertionError("recall_qps: the sweep has not 9 points")

    # latency: p50/p99 at batches 32..4096, full and pruned (26 of the
    # 123 blocks, as below)
    lines, _ = run("latency", "--n", n, "--calls", "20", "--reps", "10",
                   "--probes", "26")
    out["latency"] = [{k: x[k] for k in ("batch", "mode", "lat_p50_ms",
                                         "lat_p99_ms", "qps_chained",
                                         "recall")} for x in lines[1:]]
    for x in lines[1:]:
        if not x["lat_p99_ms"] >= x["lat_p50_ms"] > 0:
            raise AssertionError(f"latency: p99/p50 out of order: {x}")
        if x["mode"] == "full" and x["recall"] < 0.98:
            raise AssertionError(f"latency: full recall@10 < 0.98: {x}")
    if [(x["batch"], x["mode"]) for x in lines[1:]] != [
            (b, m) for b in (32, 256, 1024, 4096) for m in ("full", "pruned")]:
        raise AssertionError("latency: a batch size or mode is missing")

    # the per-batch cost split, full and pruned (at 1M x 96 there are 123
    # blocks: 26 of them is the share that 256 is of 10M's 1221)
    for tag, extra in (("full", ()), ("pruned", ("--probes", "26"))):
        (line,), _ = run("probe_epilogue", "--n", n, "--q", "4096",
                         "--reps", "10", *extra)
        out[f"probe_epilogue_{tag}"] = {
            k: v for k, v in line.items() if k.endswith("_us_per_q")}
        if not all(v > 0 for v in out[f"probe_epilogue_{tag}"].values()):
            raise AssertionError(f"probe_epilogue {tag}: a piece took 0")

    _, table = run("probe_select", "--n", n)
    out["probe_select_coverage_p64"] = {nm: cov[-1]
                                        for nm, cov in table.items()}

    lines, _ = run("probe_host_rerank", "--reps", "2")
    rr = {next(iter(x)): x[next(iter(x))] for x in lines[1:]}
    out["probe_host_rerank_ms"] = {
        k: v if k == "gather_only_ms" else v["ms_per_chunk"]
        for k, v in rr.items()}
    for name in ("inplace", "host_rerank"):
        if rr[name]["max_abs_err_vs_diff"] != 0.0:
            raise AssertionError(f"probe_host_rerank: {name} != diff")

    # pipelined == sequential, bitwise (asserted by the harness itself)
    lines, _ = run("probe_pin_pipeline", "--n", str(2 * HARNESS_N),
                   "--chunk", chunk, "--q", "2048", "--reps", "1")
    out["probe_pin_pipeline"] = lines[-1]

    store = os.path.join(tmp, "bigscale.vstore")
    lines, _ = run("bigscale", "--n", str(3 * HARNESS_N), "--chunk", n,
                   "--path", store, "--spill", os.path.join(tmp, "spill"),
                   "--reps", "2")
    out["bigscale"] = lines[-1]
    if lines[-1]["recall_at_10_sampled"] < 0.98 or os.path.exists(store):
        raise AssertionError(f"bigscale: {lines[-1]}, store left: "
                             f"{os.path.exists(store)}")
    os.rmdir(tmp)

    (line,), _ = run("probe_churn", "--sizes", n, "--reps", "2",
                     "--epochs", "2")
    out["probe_churn"] = line
    if not (line["pack_survived_adds"] and
            line["base_pack_survived_removes"]):
        raise AssertionError(f"probe_churn: a pack did not survive: {line}")

    lines, _ = run("crossover", "--n", str(HARNESS_N // 5), "--dims",
                   "2,8,96", "--reps", "3")
    out["crossover"] = lines[1:]

    for name, argv in (
            ("probe_fullscan", ("--n", n, "--reps", "5", "--configs",
                                "8192:4096:512:4,16384:4096:512:2")),
            ("probe_kernel", (n, "[(8192, 256, 4096), "
                                 "(16384, 512, 4096, 'int8f')]")),
            ("probe_block", ("--n", n, "--blocks", "8192,16384")),
            ("probe_build", (n,)),
            ("probe_ops", (n, "96", str(HARNESS_N // 16)))):
        lines, _ = run(name, *argv)
        out[name] = lines[1:]
        if any("error" in x for x in lines):
            raise AssertionError(f"{name}: {lines}")

    # the level's permutation inverse (three forms, equal), the mean_id id
    # sums (every formulation equal to the int64 sums) and the builds'
    # peak memory (the single-device and world-of-one trees equal): each
    # harness raises where its equality fails
    lines, _ = run("probe_perm", n)
    out["probe_perm"] = lines[-1]
    lines, _ = run("probe_meanid", "--n", n, "--reps", "3")
    out["probe_meanid"] = lines[-1]
    lines, _ = run("probe_sharded_mem", "--n", n)
    out["probe_sharded_mem"] = lines[1:]
    if not (out["probe_meanid"]["variants_exact"]
            and [x["variant"] for x in lines[1:]] == [
                "single_donate", "sharded_donate"]
            and all(x["peak_gib"] > 0 for x in lines[1:])):
        raise AssertionError(f"probe_meanid / probe_sharded_mem: "
                             f"{out['probe_meanid']}, {lines[1:]}")

    run("main_test")
    torch.cuda.synchronize()
    out["launches"] = dict(bucket_scan=COUNTERS["scan.launches.bf16"],
                           bucket_scan_int8f=COUNTERS["scan.launches.int8f"],
                           bucket_scan_i8=COUNTERS["scan.launches.int8"])
    out["seconds"] = secs
    out["phase_s"] = time.perf_counter() - t_phase
    if min(out["launches"].values()) < 1:
        raise AssertionError(f"the harnesses left a scan kernel unlaunched: "
                             f"{out['launches']}")
    print(f"[harness] phase 14 took {out['phase_s']:.1f} s; scan launches "
          f"{out['launches']}")
    return out


BENCH_CUT_N = 1_000_000
BENCH_BLOCK = 8192  # pack_database's block at 4096 buckets


def _moments_phase(dev):
    """Phase 16: the segment-moments kernel at N x D, k = 4, over one
    segment of every row and over segments of 17 rows, each read three
    ways: through a row index that ascends inside each segment (the
    build's own form: its partition is stable; for one segment the
    identity), through a shuffled index, and without one. Each case's
    numbers (kernel, plain and library ms, bound, errors against float64
    sums in ulps of the segment's sum of |x|, launches) under its name:
    the build's form at the top, the others under ``shuffled_index`` and
    ``no_index``. Raises where the kernel's error passes the card test's
    summation-tree bound, (1540 + n_s / 512) ulps, where on integer-valued
    rows it differs from the plain version by a bit, or where through an
    index it differs by a bit from itself on the gathered rows."""
    import torch

    from vector_database_tpu_torch.ops import sorted_build as sb
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    train, _, _, g = _clustered(dev, N, SEED + 16)
    k, reps, f64 = 4, 20, dict(dtype=torch.float64, device=dev)
    xi = torch.clamp(torch.round(train), -3, 3)
    out = {}
    for name, rows in (("one_segment", N), ("rows17", 17)):
        s = -(-N // rows)
        start = torch.arange(s, dtype=torch.int64, device=dev) * rows
        cnt = torch.clamp(N - start, max=rows)
        # the segments cover every position, so the samples are those of
        # positions 0, k, 2k, ... in order
        n_s = (start + cnt + k - 1) // k - (start + k - 1) // k
        seg = torch.repeat_interleave(torch.arange(s, device=dev), n_s)
        shuffled = torch.randperm(N, generator=g, device=dev)
        # sorted by (segment, row): each segment's rows ascend
        at = torch.arange(N, device=dev)
        ascending = torch.sort(at // rows * N + shuffled).values % N
        tol = (1540 + n_s[:, None].double() / 512) * 2.0 ** -24
        zeros = torch.zeros((s, D), dtype=torch.float32, device=dev)
        forms = {}
        for form, idx in (("main_path", ascending),
                          ("shuffled_index", shuffled), ("no_index", None)):
            ik = None if idx is None else idx[::k].contiguous()

            def sample():
                return train[::k] if ik is None else train[ik]

            def moments(x, fn=sb.segment_moments):
                return fn(x, start, cnt, k, idx)

            # library yardstick: the samples gathered, then index_add_ of
            # them and their squares by a segment-id vector made
            # beforehand (float atomics)
            def library():
                v = sample()
                return (zeros.clone().index_add_(0, seg, v),
                        zeros.clone().index_add_(0, seg, v * v))

            before = COUNTERS["build.moments.launches"]
            k_ms = _ms(lambda: moments(train), reps)
            launches = COUNTERS["build.moments.launches"] - before
            if launches != reps + 1:
                raise AssertionError(f"{launches} segment-moments launches "
                                     f"in {reps + 1} calls")
            p_ms = _ms(lambda: moments(train, sb.segment_moments_reference),
                       REPS)
            lib_ms = _ms(library, REPS)
            xs = sample().double()
            err = {}
            for label, fn in (("kernel", sb.segment_moments),
                              ("plain", sb.segment_moments_reference)):
                got = moments(train, fn)
                for i, v in enumerate((xs, xs * xs)):
                    ref = torch.zeros((s, D), **f64).index_add_(0, seg, v)
                    scale = torch.zeros((s, D), **f64).index_add_(
                        0, seg, v.abs())
                    diff = (got[i].double() - ref).abs()
                    key = f"{label}_{'sum' if i == 0 else 'sumsq'}_err_ulps"
                    err[key] = float((diff / (scale * 2.0 ** -24)).max())
                    if label == "kernel" and \
                            not bool((diff <= tol * scale).all()):
                        raise AssertionError(
                            f"segment moments {name} {form}: {key} "
                            f"{err[key]} passes the bound of (1540 + n_s / "
                            f"512) ulps")
            del xs
            got = moments(xi)
            want = moments(xi, sb.segment_moments_reference)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"segment moments {name} {form}: the "
                                     f"kernel and the plain version differ "
                                     f"on integer rows")
            if idx is not None:
                got = moments(train)
                want = sb.segment_moments(train[idx], start, cnt, k)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(
                        f"segment moments {name} {form}: through the index "
                        f"the kernel differs from itself on x[rows]")
                del got, want
            # the samples' rows, the index's 8 B a sample, the sums out
            nbytes = int(n_s.sum()) * (D * 4 + (0 if idx is None else 8)) \
                + 2 * s * D * 4 + 2 * s * 8
            bound_ms = nbytes / PEAK_HBM * 1e3
            forms[form] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by="bytes",
                               pct_of_bound=100.0 * bound_ms / k_ms,
                               launches=launches, integer_rows_equal=True,
                               **err)
            print(f"[moments] {name} {form}: {s} segments, kernel "
                  f"{k_ms:.3f} ms, bound {bound_ms:.3f} ms "
                  f"({100 * bound_ms / k_ms:.1f}%), plain {p_ms:.3f} ms, "
                  f"library {lib_ms:.3f} ms, errors {err}, integer rows "
                  f"equal" + ("" if idx is None else ", equal to the "
                              "kernel on the gathered rows"))
        main = forms.pop("main_path")
        out[name] = dict(segments=s, index="ascending by segment", **main,
                         **forms)
    del train, xi
    return out


def _delta_knn_phase(dev):
    """Phase 17: the delta k-NN kernel at the churn cell's merge shape;
    its numbers (kernel, plain and library ms, bound, largest relative
    error against float64, launches). Raises where a distance passes
    2e-5 relative of float64, where the ids differ from the plain
    version's at a clear k-th place, or where on integer rows the kernel
    and the plain version differ by a bit."""
    import numpy as np
    import torch

    from vector_database_tpu_torch.ops import delta_knn as tdk
    from vector_database_tpu_torch.utils.profiling import COUNTERS

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    rows = torch.randn((DELTA_LIVE, D), generator=g, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    delta = torch.zeros((DELTA_R, D), device=dev)
    delta[:DELTA_LIVE] = rows
    live = np.zeros(DELTA_R, bool)
    live[:DELTA_LIVE] = True
    half = DELTA_Q // 2
    pick = torch.randint(0, DELTA_LIVE, (half,), generator=g, device=dev)
    q = torch.cat([
        rows[pick] + 0.002 * torch.randn((half, D), generator=g, device=dev),
        rows[torch.randint(0, DELTA_LIVE, (DELTA_Q - half,), generator=g,
                           device=dev)].roll(1, dims=1)])
    before = COUNTERS["dynamic.delta_knn.launches"]
    k_ms = _ms(lambda: tdk.delta_knn(q, delta, live, K), REPS)
    launches = COUNTERS["dynamic.delta_knn.launches"] - before
    per_call = launches // (REPS + 1)
    if launches < 1 or launches != per_call * (REPS + 1):
        raise AssertionError(f"{launches} delta_knn launches in {REPS + 1} "
                             f"calls")
    p_ms = _ms(lambda: tdk.delta_knn_reference(q, delta, live, K), REPS)
    lib_ms = _ms(lambda: torch.topk(torch.cdist(q, rows), K, dim=1,
                                    largest=False), REPS)

    def f64(slots):
        return ((q.double()[:, None, :] - delta.double()[slots]) ** 2).sum(-1)

    got_d, got_s = tdk.delta_knn(q, delta, live, K)
    exact = f64(got_s)
    rel = float(((got_d.double() - exact).abs() / exact).max())
    if rel > 2e-5:
        raise AssertionError(f"delta_knn distance off float64 by {rel}")
    want_d, want_s = tdk.delta_knn_reference(q, delta, live, K + 1)
    want_exact = f64(want_s[:, :K])
    prel = float(((want_d[:, :K].double() - want_exact).abs()
                  / want_exact).max())
    clear = (want_d[:, K] - want_d[:, K - 1]) > 2e-5 * want_d[:, K]
    if not torch.equal(got_s[clear].sort(1).values,
                       want_s[clear, :K].sort(1).values):
        raise AssertionError("delta_knn ids differ from the plain "
                             "version's at a clear k-th place")
    qi, di = torch.round(q * 2), torch.round(delta * 2)
    ki = tdk.delta_knn(qi, di, live, K)
    pi = tdk.delta_knn_reference(qi, di, live, K)
    if not (torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1])):
        raise AssertionError("delta_knn differs from the plain version on "
                             "integer rows")
    ops = 3.0 * DELTA_Q * D * DELTA_LIVE
    nbytes = (DELTA_Q * D + DELTA_LIVE * D) * 4 + DELTA_Q * K * 12
    out = dict(q=DELTA_Q, slots=DELTA_R, live=DELTA_LIVE, d=D, k=K,
               **_numbers(k_ms, ops, nbytes, PEAK_F32, lib_ms),
               plain_ms=p_ms, launches=launches, launches_per_call=per_call,
               max_rel_err_f64=rel, plain_max_rel_err_f64=prel,
               clear_kth_share=float(clear.float().mean()),
               integer_rows_equal=True)
    print(f"[delta_knn] q={DELTA_Q}, {DELTA_R} slots ({DELTA_LIVE} live), "
          f"d={D}, k={K}: kernel {k_ms:.3f} ms, bound {out['bound_ms']:.3f} "
          f"ms ({out['bound_by']}, {out['pct_of_bound']:.1f}%), plain "
          f"{p_ms:.3f} ms, cdist + topk {lib_ms:.3f} ms; max rel err vs "
          f"float64 {rel:.2e} (plain {prel:.2e}); ids equal the plain "
          f"version's at {out['clear_kth_share']:.4f} of queries (a clear "
          f"k-th place); integer rows equal; launches {launches} "
          f"({per_call} a call)")
    return out


def _bench_keys(env, nb):
    """The keys JAX's ``bench.py`` prints for the knobs in ``env`` when the
    serving pack has ``nb`` blocks (one rank: the sharded pack too)."""
    keys = {"metric", "value", "unit", "vs_baseline", "serve_n", "serve_q",
            "serve_buckets", "serve_pack_s", "serve_full_qps",
            "serve_full_recall", "serve_sharded_devices",
            "serve_sharded_pack_s", "serve_sharded_full_qps",
            "serve_sharded_full_recall"}
    if env.get("VDB_BENCH_SHARDED") != "1":
        keys |= {"build_sharded_vps", "build_sharded_devices"}
    pts = sorted({min(int(p), nb) for p in
                  env.get("VDB_BENCH_PROBES", "192,256,320").split(",")})
    if pts[-1] < nb:
        keys |= {"serve_pruned", "serve_headline_qps", "serve_headline_recall",
                 "serve_headline_probes", "serve_qps_vs_target",
                 "serve_sharded_pruned"}
    elif pts[len(pts) // 2] < nb:
        keys.add("serve_sharded_pruned")
    return keys


def _run_bench(env, rows_out=None):
    """``vector_database_tpu_torch.bench.main`` in this process with the
    knobs in ``env`` (none else): ``(its one JSON line, seconds)``, held
    to return value 0, no ``*_error`` field and JAX's key set. Its output
    is kept, and printed if it raises."""
    import contextlib
    import io

    import torch

    from vector_database_tpu_torch import bench

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = bench.main(env=env, rows_out=rows_out)
        torch.cuda.synchronize()
    except BaseException:
        print(f"[bench] {env} failed; its output:\n" + buf.getvalue())
        raise
    secs = time.perf_counter() - t0
    (line,) = [json.loads(x) for x in buf.getvalue().splitlines()]
    print(f"[bench] {env or 'defaults'}: {secs:.2f} s, returned {ret}")
    if ret != 0 or [k for k in line if k.endswith("_error")]:
        raise AssertionError(f"bench {env} returned {ret}: {line}")
    n = int(env.get("VDB_BENCH_N", N))
    if set(line) != _bench_keys(env, -(-n // BENCH_BLOCK)):
        raise AssertionError(f"bench {env}: keys {sorted(line)} are not "
                             "JAX's")
    return line, secs


def _bench_phase(dev):
    """Phase 15: the headline bench (``vector_database_tpu_torch.bench``)
    at its defaults, then its ingest, sharded-primary and ``mean_id``
    legs at BENCH_CUT_N rows; the scan kernel's launches counted over the
    headline run."""
    import torch
    import torch.distributed as dist

    from vector_database_tpu_torch.utils.profiling import COUNTERS

    t_phase = time.perf_counter()
    rows = {}
    COUNTERS["scan.launches.bf16"] = 0
    line, secs = _run_bench({}, rows)
    launches = COUNTERS["scan.launches.bf16"]
    if line["serve_full_recall"] < 0.98:
        raise AssertionError(f"bench: full recall@10 < 0.98: {line}")
    if [x["probes"] for x in line["serve_pruned"]] != list(PROBES):
        raise AssertionError(f"bench: pruned points {line['serve_pruned']}")
    if line["serve_sharded_full_recall"] != line["serve_full_recall"]:
        raise AssertionError("bench: the sharded recall != the "
                             "single-device recall")
    p = line["serve_sharded_pruned"]["probes"]
    for sharded, single in (("sharded_full", "full"),
                            ("sharded_pruned", f"pruned_{p}")):
        if not all(torch.equal(a, b)
                   for a, b in zip(rows[sharded], rows[single])):
            raise AssertionError(f"bench: {sharded} != {single} (world of "
                                 "one, bitwise)")
    if launches < 1:
        raise AssertionError("the bench launched no bf16 scan kernel")
    print(f"[bench] world of one: full and pruned {p} rows == the "
          f"single-device rows (bitwise); bucket_scan launches {launches}")
    out = dict(headline=line, launches=launches, seconds=dict(headline=secs))
    del rows
    for name, knob, value in (("ingest", "VDB_BENCH_INGEST", "1"),
                              ("sharded", "VDB_BENCH_SHARDED", "1"),
                              ("mean_id", "VDB_BENCH_TIE", "mean_id")):
        out[name], out["seconds"][name] = _run_bench(
            {"VDB_BENCH_N": str(BENCH_CUT_N), knob: value})
    if dist.is_initialized():
        raise AssertionError("the bench left a process group behind")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[bench] phase 15 took {out['phase_s']:.1f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                 "is False); this script runs only on a GPU")

    from vector_database_tpu_torch import (
        PackedServer,
        build_index_fused,
        exact_ball,
        exact_knn,
        knn,
        pack_database,
        pallas_scan_knn,
        pallas_scan_knn_packed,
        pallas_scan_knn_packed_rt,
        search,
    )
    from vector_database_tpu_torch.benchmarks import probe_kernel_ab as pab
    from vector_database_tpu_torch.ops import bucket_scan as bs
    from vector_database_tpu_torch.ops import bucket_scan_i8 as bi
    from vector_database_tpu_torch.ops import cuda_build, sorted_build
    from vector_database_tpu_torch.ops import delta_knn as tdk
    from vector_database_tpu_torch.ops.packed_knn import (
        _block_map,
        _scan_queries,
    )
    from vector_database_tpu_torch.utils.profiling import COUNTERS
    from vector_database_tpu_torch.search import calibrate_radius

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build -----------------------------------------------------
    sources = ("bucket_scan_sm90", "bucket_scan_i8", "probe_kernel_ab",
               "segment_moments", "delta_knn")
    found = sum(cuda_build.library_path(x).exists() for x in sources)
    start = ("cold (no library in build/)" if found == 0 else
             "cached (every library found in build/)"
             if found == len(sources) else
             f"partly cached ({found} of {len(sources)} libraries found)")
    t0 = time.perf_counter()
    cuda_build.build(*sources)
    for mod in (bs, bi, pab, sorted_build, tdk):
        mod._load()
    print(f"[build] vector_database_tpu_torch/csrc: bucket_scan_sm90.cu, "
          f"bucket_scan_i8.cu, probe_kernel_ab.cu (each with sm90.cuh), "
          f"segment_moments.cu, delta_knn.cu, one nvcc each, {start}: "
          f"built and loaded in {time.perf_counter() - t0:.2f} s")

    # ---- 2. exactness where the scan is exact (n <= buckets) ------------
    g = torch.Generator(device=dev).manual_seed(42)
    vecs = torch.rand((4000, 24), generator=g, device=dev) * 2 - 1
    qs = torch.rand((64, 24), generator=g, device=dev) * 2 - 1
    rows, d2 = pallas_scan_knn(vecs, qs, k=5)
    erows, ed2 = exact_knn(vecs, qs, k=5)
    if any(set(a) != set(b)
           for a, b in zip(rows.tolist(), erows.tolist())):
        raise AssertionError("kernel full scan != exact_knn at n <= buckets")
    torch.testing.assert_close(d2.sort(1).values, ed2.sort(1).values,
                               rtol=1e-4, atol=1e-5)
    print("[exact] 4000x24, 64 queries, k=5: kernel scan == exact_knn")

    # ---- 3. the main path ----------------------------------------------
    train, test, _, _ = _clustered(dev, N, SEED)
    torch.cuda.synchronize()

    COUNTERS["scan.launches.bf16"] = 0
    moments0 = COUNTERS["build.moments.launches"]
    t0 = time.perf_counter()
    index = build_index_fused(train, leaf_size=LEAF)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[main] build {N}x{D} leaf {LEAF}: {build_s:.3f} s, "
          f"{N / build_s:.1f} vectors/s, depth {index.depth}, "
          f"{index.num_leaves} leaves")
    build_moments = COUNTERS["build.moments.launches"] - moments0
    if build_moments != index.depth:
        raise AssertionError(f"{build_moments} segment-moments launches "
                             f"in a build of depth {index.depth}")
    print(f"[main] segment_moments launches in the build: {build_moments}")
    t0 = time.perf_counter()
    again = build_index_fused(train, leaf_size=LEAF)
    torch.cuda.synchronize()
    build2_s = time.perf_counter() - t0
    del train
    print(f"[main] the same build again: {build2_s:.3f} s, "
          f"{again.num_leaves} leaves (first {index.num_leaves})")
    if not _same_tree(index, again):
        raise AssertionError("two builds of one input gave two trees")
    print("[main] the two builds' node tables are equal field by field")
    del again

    t0 = time.perf_counter()
    pack = pack_database(index.vectors, buckets=BUCKETS)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    nb = pack.vb.shape[0]
    print(f"[main] pack: {pack_s:.3f} s, nb={nb} block={pack.block} "
          f"m={pack.m} d_pad={pack.d_pad} bits={pack.bits}")

    truth = exact_knn(index.vectors, test[:TRUTH_Q], k=K)[0]
    results = {}
    full = PackedServer(pack, k=K, batch=Q)
    full.warmup()
    ms = _ms(lambda: full.query(test), REPS)
    rec = _recall(full.query(test)[0][:TRUTH_Q], truth)
    results["full"] = dict(ms=ms, qps=Q / ms * 1e3, recall=rec)
    print(f"[main] full scan q={Q}: {ms:.3f} ms, {Q / ms * 1e3:.1f} QPS, "
          f"recall@{K} {rec:.4f}")
    if rec < 0.98:
        raise AssertionError(f"full-scan recall@{K} {rec} < 0.98")
    pruned = PackedServer(pack, k=K, batch=Q, probes=PROBES[0],
                          probes_max=max(PROBES))
    pruned.warmup()
    for p in PROBES:
        pruned.set_probes(p)
        ms = _ms(lambda: pruned.query(test), REPS)
        rec = _recall(pruned.query(test)[0][:TRUTH_Q], truth)
        results[f"probes{p}"] = dict(ms=ms, qps=Q / ms * 1e3, recall=rec)
        print(f"[main] pruned probes={p} ({p / nb:.4f} of blocks): "
              f"{ms:.3f} ms, {Q / ms * 1e3:.1f} QPS, recall@{K} {rec:.4f}")
    torch.cuda.synchronize()
    launches = COUNTERS["scan.launches.bf16"]
    if launches < 1:
        raise AssertionError("the main path never launched bucket_scan")
    print(f"[main] bucket_scan launches on the main path: {launches}")

    # ---- 4. kernel vs plain at the main path's shapes -------------------
    d_pad, q_tile = pack.d_pad, 512
    qb = torch.zeros((Q, d_pad), device=dev)
    qb[:, :D] = test
    qb = qb.bfloat16()
    args = dict(m=pack.m, bits=pack.bits)
    acc_k = bs.bucket_scan(pack.vn, pack.vb, qb, **args)
    acc_p = bs.bucket_scan_reference(pack.vn, pack.vb, qb, **args)
    full_err, full_mis = _compare_acc(acc_k, acc_p, pack, qb)
    k_ms = _ms(lambda: bs.bucket_scan(pack.vn, pack.vb, qb, **args), REPS)
    p_ms = _ms(lambda: bs.bucket_scan_reference(pack.vn, pack.vb, qb,
                                                **args), REPS)
    block_bytes = d_pad * pack.block * 2 + pack.block * 4  # vb + vn
    full_ops = 2 * Q * nb * pack.block * d_pad
    full_k = _numbers(k_ms, full_ops,
                      nb * block_bytes + _nbytes(qb, acc_k), PEAK_BF16,
                      _matmul_ms(qb, pack.vb, nb))
    print(f"[kernel] full scan {Q}x{nb} blocks: kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.3f} ms, max |score err| {full_err:.3g}, "
          f"block-id ties {full_mis:.2e}; bound {full_k['bound_ms']:.3f} ms "
          f"({full_k['bound_by']}), {full_k['tflops']:.1f} TFLOP/s, "
          f"{full_k['pct_of_bound']:.1f}% of bound; torch.matmul of the "
          f"same products {full_k['library_ms']:.3f} ms")

    order, bmap = _block_map(pack, test, q_tile=q_tile, probes=max(PROBES))
    qs_sorted = qb[order]
    pargs = dict(args, bmap=bmap, nprobe=min(256, nb), q_tile=q_tile)
    pk = bs.bucket_scan(pack.vn, pack.vb, qs_sorted, **pargs)
    pp = bs.bucket_scan_reference(pack.vn, pack.vb, qs_sorted, **pargs)
    pr_err, pr_mis = _compare_acc(pk, pp, pack, qs_sorted)
    pk_ms = _ms(lambda: bs.bucket_scan(pack.vn, pack.vb, qs_sorted,
                                       **pargs), REPS)
    pp_ms = _ms(lambda: bs.bucket_scan_reference(pack.vn, pack.vb,
                                                 qs_sorted, **pargs), REPS)
    probe = pargs["nprobe"]
    # every query streams `probe` blocks; the blocks some group reads
    # cross HBM once
    read = torch.unique(bmap[:, :probe]).numel()
    pruned_k = _numbers(pk_ms, 2 * Q * probe * pack.block * d_pad,
                        read * block_bytes + _nbytes(qs_sorted, pk),
                        PEAK_BF16, _matmul_ms(qb, pack.vb, probe))
    print(f"[kernel] pruned {probe} of {nb} blocks: kernel {pk_ms:.3f} ms, "
          f"plain {pp_ms:.3f} ms, max |score err| {pr_err:.3g}, "
          f"block-id ties {pr_mis:.2e}; bound {pruned_k['bound_ms']:.3f} ms "
          f"({pruned_k['bound_by']}), {pruned_k['tflops']:.1f} TFLOP/s, "
          f"{pruned_k['pct_of_bound']:.1f}% of bound; torch.matmul "
          f"{pruned_k['library_ms']:.3f} ms")

    _, all_map = _block_map(pack, test, q_tile=q_tile, probes=nb)
    acc_all = bs.bucket_scan(pack.vn, pack.vb, qs_sorted, **dict(
        args, bmap=all_map, nprobe=nb, q_tile=q_tile))
    if not torch.equal(acc_all, bs.bucket_scan(pack.vn, pack.vb, qs_sorted,
                                               **args)):
        raise AssertionError("probes = nb accumulator != full scan")
    fr, fd = pallas_scan_knn_packed(pack, test, k=K, q_tile=q_tile)
    ar, ad = pallas_scan_knn_packed_rt(pack, test, nb, k=K, probes_max=nb,
                                       q_tile=q_tile)
    if not (torch.equal(fr, ar) and torch.equal(fd, ad)):
        raise AssertionError("probes = nb results != full scan")
    sr, sd = pallas_scan_knn_packed(pack, test, k=K, q_tile=q_tile,
                                    probes=256)
    rr, rd = pallas_scan_knn_packed_rt(pack, test, 256, k=K,
                                       probes_max=max(PROBES),
                                       q_tile=q_tile)
    if not (torch.equal(sr, rr) and torch.equal(sd, rd)):
        raise AssertionError("runtime probes != static probes")
    print("[kernel] probes=nb == full scan (bitwise); runtime probes 256 "
          "== static probes 256 (bitwise)")
    del acc_k, acc_p, pk, pp, acc_all

    # ---- 5. exact radius search through the tree -----------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    v8 = torch.rand((TREE_N, TREE_D), generator=g, device=dev) * 2 - 1
    q8 = torch.rand((64, TREE_D), generator=g, device=dev) * 2 - 1
    t0 = time.perf_counter()
    tree = build_index_fused(v8, leaf_size=16)
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    radius = calibrate_radius(v8, q8, K, 0.95)
    res = search(tree, q8, radius)
    ball = exact_ball(v8, q8, radius)
    for i in range(q8.shape[0]):
        want = set(torch.nonzero(ball[i])[:, 0].tolist())
        if set(res.match_rows(i).tolist()) != want:
            raise AssertionError(f"search != exact_ball for query {i}")
    krows, kd2 = knn(tree, q8, K, radius)
    erows, ed2 = exact_knn(v8, q8, k=K)
    full_rows = torch.isfinite(kd2).all(dim=1)
    for i in torch.nonzero(full_rows)[:, 0].tolist():
        if set(krows[i].tolist()) != set(erows[i].tolist()):
            raise AssertionError(f"knn != exact_knn for query {i}")
    print(f"[tree] {TREE_N}x{TREE_D} build {tree_s:.3f} s; search "
          f"r={radius:.4f}: 64 queries == exact_ball "
          f"({int(res.count.sum())} matches); knn == exact_knn on "
          f"{int(full_rows.sum())} full rows")

    # ---- 6. int8 and int8f packs at full width -------------------------
    bf16_bytes = pack.vb.numel() * pack.vb.element_size()
    COUNTERS["scan.launches.bf16"] = COUNTERS["scan.launches.int8f"] = 0
    COUNTERS["scan.launches.int8"] = 0
    packs = {}
    for dtype in ("int8", "int8f"):
        t0 = time.perf_counter()
        p8 = pack_database(index.vectors, buckets=BUCKETS, dtype=dtype)
        torch.cuda.synchronize()
        p8_s = time.perf_counter() - t0
        vb_bytes = p8.vb.numel() * p8.vb.element_size()
        if 2 * vb_bytes != bf16_bytes:
            raise AssertionError(f"{dtype} blocks take {vb_bytes} bytes, "
                                 f"not half of bf16's {bf16_bytes}")
        srv = PackedServer(p8, k=K, batch=Q)
        srv.warmup()
        ms = _ms(lambda: srv.query(test), REPS)
        rec = _recall(srv.query(test)[0][:TRUTH_Q], truth)
        results[f"{dtype}_full"] = dict(ms=ms, qps=Q / ms * 1e3, recall=rec,
                                        pack_s=p8_s)
        print(f"[int8] {dtype} pack: {p8_s:.3f} s, vb {vb_bytes} bytes "
              f"(bf16 {bf16_bytes}), sq {p8.sq!r}; full scan q={Q}: "
              f"{ms:.3f} ms, {Q / ms * 1e3:.1f} QPS, recall@{K} {rec:.4f}")
        if rec < 0.90:
            raise AssertionError(f"{dtype} full-scan recall@{K} {rec} < 0.9")
        packs[dtype] = p8
    p8f = packs["int8f"]
    pruned8 = PackedServer(p8f, k=K, batch=Q, probes=PROBES[0],
                           probes_max=max(PROBES))
    pruned8.warmup()
    for p in PROBES:
        pruned8.set_probes(p)
        ms = _ms(lambda: pruned8.query(test), REPS)
        rec = _recall(pruned8.query(test)[0][:TRUTH_Q], truth)
        results[f"int8f_probes{p}"] = dict(ms=ms, qps=Q / ms * 1e3,
                                           recall=rec)
        print(f"[int8] int8f pruned probes={p}: {ms:.3f} ms, "
              f"{Q / ms * 1e3:.1f} QPS, recall@{K} {rec:.4f}")
    torch.cuda.synchronize()
    i8_launches = COUNTERS["scan.launches.int8"]
    i8f_launches = COUNTERS["scan.launches.int8f"]
    if i8_launches < 1 or i8f_launches < 1:
        raise AssertionError(f"int8 path launches: i8 {i8_launches}, "
                             f"int8f {i8f_launches}")
    print(f"[int8] launches on the int8 paths: bucket_scan_i8 "
          f"{i8_launches}, bucket_scan int8f {i8f_launches}, bf16 "
          f"{COUNTERS['scan.launches.bf16']}")

    qp = torch.zeros((Q, d_pad), device=dev)
    qp[:, :D] = test
    p8 = packs["int8"]
    qi = _scan_queries(p8, qp)
    sk, ik = bi.bucket_scan_i8(p8.vn, p8.vb, qi, m=p8.m)
    sp, ip = bi.bucket_scan_i8_reference(p8.vn, p8.vb, qi, m=p8.m)
    i8_err = float((sk - sp).abs().max())
    if not (torch.equal(sk, sp) and torch.equal(ik, ip)):
        raise AssertionError(f"i8 kernel != plain: max |score err| {i8_err},"
                             f" {int((ik != ip).sum())} block ids differ")
    i8_ms = _ms(lambda: bi.bucket_scan_i8(p8.vn, p8.vb, qi, m=p8.m), REPS)
    i8_plain_ms = _ms(lambda: bi.bucket_scan_i8_reference(
        p8.vn, p8.vb, qi, m=p8.m), REPS)
    i8_k = _numbers(i8_ms, full_ops, _nbytes(p8.vb, p8.vn, qi, sk, ik),
                    PEAK_INT8, _int_mm_ms(qi, p8.vb, nb))
    print(f"[int8] i8 kernel {Q}x{nb} K-major blocks: kernel {i8_ms:.3f} "
          f"ms, plain {i8_plain_ms:.3f} ms, scores and block ids bitwise "
          f"equal; bound {i8_k['bound_ms']:.3f} ms ({i8_k['bound_by']}), "
          f"{i8_k['tflops']:.1f} TOP/s, {i8_k['pct_of_bound']:.1f}% of "
          f"bound; torch._int_mm {i8_k['library_ms']}")
    del sk, ik, sp, ip

    qf = _scan_queries(p8f, qp)
    args8 = dict(m=p8f.m, bits=p8f.bits)
    acc_k = bs.bucket_scan(p8f.vn, p8f.vb, qf, **args8)
    acc_p = bs.bucket_scan_reference(p8f.vn, p8f.vb, qf, **args8)
    i8f_err, i8f_mis = _compare_acc(acc_k, acc_p, p8f, qf)
    i8f_ms = _ms(lambda: bs.bucket_scan(p8f.vn, p8f.vb, qf, **args8), REPS)
    i8f_plain_ms = _ms(lambda: bs.bucket_scan_reference(
        p8f.vn, p8f.vb, qf, **args8), REPS)
    i8f_k = _numbers(i8f_ms, full_ops,
                     _nbytes(p8f.vb, p8f.vn, qf, acc_k), PEAK_BF16,
                     _matmul_ms(qf, p8f.vb, nb))
    print(f"[int8] int8f kernel {Q}x{nb} blocks: kernel {i8f_ms:.3f} ms, "
          f"plain {i8f_plain_ms:.3f} ms, max |score err| {i8f_err:.3g}, "
          f"block-id ties {i8f_mis:.2e}; bound {i8f_k['bound_ms']:.3f} ms "
          f"({i8f_k['bound_by']}), {i8f_k['pct_of_bound']:.1f}% of bound; "
          f"torch.matmul {i8f_k['library_ms']:.3f} ms")
    order, bmap8 = _block_map(p8f, test, q_tile=q_tile, probes=max(PROBES))
    qfs = qf[order]
    pargs8 = dict(args8, bmap=bmap8, nprobe=min(256, nb), q_tile=q_tile)
    pk = bs.bucket_scan(p8f.vn, p8f.vb, qfs, **pargs8)
    pp = bs.bucket_scan_reference(p8f.vn, p8f.vb, qfs, **pargs8)
    i8p_err, i8p_mis = _compare_acc(pk, pp, p8f, qfs)
    i8p_ms = _ms(lambda: bs.bucket_scan(p8f.vn, p8f.vb, qfs, **pargs8), REPS)
    i8p_plain_ms = _ms(lambda: bs.bucket_scan_reference(
        p8f.vn, p8f.vb, qfs, **pargs8), REPS)
    probe8 = pargs8["nprobe"]
    read8 = torch.unique(bmap8[:, :probe8]).numel()
    i8p_k = _numbers(i8p_ms, 2 * Q * probe8 * p8f.block * d_pad,
                     read8 * (d_pad * p8f.block + p8f.block * 4)
                     + _nbytes(qfs, pk), PEAK_BF16,
                     _matmul_ms(qf, p8f.vb, probe8))
    print(f"[int8] int8f pruned {probe8} of {nb} blocks: kernel "
          f"{i8p_ms:.3f} ms, plain {i8p_plain_ms:.3f} ms, max |score err| "
          f"{i8p_err:.3g}, block-id ties {i8p_mis:.2e}; bound "
          f"{i8p_k['bound_ms']:.3f} ms ({i8p_k['bound_by']}), "
          f"{i8p_k['pct_of_bound']:.1f}% of bound; torch.matmul "
          f"{i8p_k['library_ms']:.3f} ms")
    _, all_map = _block_map(p8f, test, q_tile=q_tile, probes=nb)
    acc_all = bs.bucket_scan(p8f.vn, p8f.vb, qfs, **dict(
        args8, bmap=all_map, nprobe=nb, q_tile=q_tile))
    if not torch.equal(acc_all, bs.bucket_scan(p8f.vn, p8f.vb, qfs,
                                               **args8)):
        raise AssertionError("int8f probes = nb accumulator != full scan")
    sr, sd = pallas_scan_knn_packed(p8f, test, k=K, q_tile=q_tile,
                                    probes=256)
    rr, rd = pallas_scan_knn_packed_rt(p8f, test, 256, k=K,
                                       probes_max=max(PROBES),
                                       q_tile=q_tile)
    if not (torch.equal(sr, rr) and torch.equal(sd, rd)):
        raise AssertionError("int8f runtime probes != static probes")
    print("[int8] int8f probes=nb == full scan (bitwise); runtime probes "
          "256 == static probes 256 (bitwise)")
    # a tombstoned int8f pack: a seeded 1% of rows dead (3e38 norms)
    g8 = torch.Generator(device=dev).manual_seed(SEED + 4)
    p8m = p8f.mask_rows(torch.rand(N, generator=g8, device=dev) >= 0.01)
    acc_k = bs.bucket_scan(p8m.vn, p8m.vb, qf, **args8)
    acc_p = bs.bucket_scan_reference(p8m.vn, p8m.vb, qf, **args8)
    i8m_err, i8m_mis = _compare_acc(acc_k, acc_p, p8m, qf)
    print(f"[int8] int8f kernel on a masked pack (1% dead): max |score "
          f"err| {i8m_err:.3g}, block-id ties {i8m_mis:.2e}")
    del full, pruned, srv, pruned8, pack, packs, p8, p8f, p8m, index
    del acc_k, acc_p, acc_all, pk, pp
    torch.cuda.empty_cache()
    u8 = _uint8_scan(dev)
    torch.cuda.empty_cache()

    # ---- 7. bucket counts no 64-column tile divides ---------------------
    tail = _tail_phase(dev)
    torch.cuda.empty_cache()

    # ---- 8. the A/B scan probe -------------------------------------------
    w_ab = pab.BLOCK // pab.M
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    small = dict(generator=g, device=dev)
    vb3 = torch.randint(-2, 3, (3, pab.D_PAD, pab.BLOCK), **small).bfloat16()
    vn3 = torch.randint(0, 9, (3, 1, pab.BLOCK), **small).float()
    q3 = torch.randint(-2, 3, (256, pab.D_PAD), **small).bfloat16()
    qn3 = torch.randint(0, 9, (256, 1), **small).float()
    args3 = dict(m=pab.M, bits=pab.id_bits(3, w_ab))
    for mode in pab.MODES:
        if not torch.equal(
                pab.probe_kernel_ab(mode, vn3, vb3, q3, qn3, **args3),
                pab.probe_kernel_ab_reference(mode, vn3, vb3, q3, qn3,
                                              **args3)):
            raise AssertionError(f"A/B probe {mode} kernel != plain")
    print(f"[probe] {', '.join(pab.MODES)}: kernel == plain (bitwise) on "
          "small integers, 3 blocks")
    del vb3, vn3, q3, qn3
    pab.probe_kernel_ab.LAUNCHES = 0
    ab = pab.run(N)
    torch.cuda.synchronize()
    ab_launches = pab.probe_kernel_ab.LAUNCHES
    if ab_launches < len(pab.MODES):
        raise AssertionError(f"the probe launched its kernel {ab_launches} "
                             "times")
    for r in ab:
        print(json.dumps(r))
    print(f"[probe] launches from its entry point: {ab_launches}")
    # kernel vs plain at the probe's full size, on small integers: the
    # probe takes an int32 min of float bits, so a score whose sign
    # differs between two summation orders picks another candidate, and
    # no float tolerance holds; with exact sums the two must agree bitwise
    nb_ab = -(-N // pab.BLOCK)
    vb_ab = torch.randint(-2, 3, (nb_ab, pab.D_PAD, pab.BLOCK),
                          dtype=torch.int8, **small).bfloat16()
    vn_ab = torch.randint(0, 9, (nb_ab, 1, pab.BLOCK), **small).float()
    q_ab = torch.randint(-2, 3, (pab.Q, pab.D_PAD), **small).bfloat16()
    qn_ab = torch.randint(0, 9, (pab.Q, 1), **small).float()
    ab_args = dict(m=pab.M, bits=pab.id_bits(nb_ab, w_ab))
    ab_k = pab.probe_kernel_ab("full", vn_ab, vb_ab, q_ab, qn_ab, **ab_args)
    ab_p = pab.probe_kernel_ab_reference("full", vn_ab, vb_ab, q_ab, qn_ab,
                                         **ab_args)
    ab_err = float((ab_k.double() - ab_p.double()).abs().max())
    if not torch.equal(ab_k, ab_p):
        raise AssertionError(f"A/B probe full kernel != plain at {N} rows")
    ab_ms = _ms(lambda: pab.probe_kernel_ab("full", vn_ab, vb_ab, q_ab,
                                            qn_ab, **ab_args), REPS)
    ab_plain_ms = _ms(lambda: pab.probe_kernel_ab_reference(
        "full", vn_ab, vb_ab, q_ab, qn_ab, **ab_args), 1)
    ab_n = _numbers(ab_ms, 2 * pab.Q * nb_ab * pab.BLOCK * pab.D_PAD,
                    _nbytes(vn_ab, vb_ab, q_ab, qn_ab, ab_k), PEAK_BF16,
                    _matmul_ms(q_ab, vb_ab, nb_ab))
    print(f"[probe] full at {N} rows, {pab.Q} queries, small integers: "
          f"kernel {ab_ms:.3f} ms, plain {ab_plain_ms:.3f} ms, bitwise "
          f"equal; bound {ab_n['bound_ms']:.3f} ms ({ab_n['bound_by']}), "
          f"{ab_n['pct_of_bound']:.1f}% of bound; torch.matmul "
          f"{ab_n['library_ms']:.3f} ms")
    del vn_ab, vb_ab, q_ab, qn_ab, ab_k, ab_p
    # the split at the serving batch, beside the scan kernel of phase 4
    vn_ab, vb_ab, q_ab, qn_ab = pab.make_inputs(N, q=Q)
    ab_args = dict(m=pab.M, bits=pab.id_bits(vb_ab.shape[0], w_ab))
    split = {mode: _ms(lambda: pab.probe_kernel_ab(
        mode, vn_ab, vb_ab, q_ab, qn_ab, **ab_args), REPS)
        for mode in pab.MODES}
    print(f"[probe] the four modes at q={Q} (the scan kernel alone took "
          f"{k_ms:.3f} ms): " + ", ".join(f"{mode} {t:.3f} ms"
                                          for mode, t in split.items()))
    del vn_ab, vb_ab, q_ab, qn_ab
    torch.cuda.empty_cache()

    # ---- 9. the mutable collections ----------------------------------------
    dyn = _dynamic_phase(dev)
    store = _store_phase(dev)
    torch.cuda.empty_cache()

    # ---- 10. out-of-core serving; 11. the in-memory models --------------
    ooc = _ooc_phase(dev, k_ms)
    models = _models_phase(dev)
    torch.cuda.empty_cache()

    # ---- 12. the mesh at world size 1 over NCCL -------------------------
    mesh = _mesh_phase(dev, results["full"]["qps"])
    torch.cuda.empty_cache()

    # ---- 13. the host-loop build ----------------------------------------
    hl = _hostloop_phase(dev, build_s)
    torch.cuda.empty_cache()

    # ---- 14. the measurement harnesses ----------------------------------
    harness = _harness_phase(dev)
    torch.cuda.empty_cache()

    # ---- 15. the headline bench -----------------------------------------
    bench = _bench_phase(dev)
    torch.cuda.empty_cache()

    # ---- 16. the build's segment moments --------------------------------
    moments = _moments_phase(dev)
    torch.cuda.empty_cache()

    # ---- 17. the delta merge's k best -------------------------------------
    delta_knn = _delta_knn_phase(dev)

    print(json.dumps({"main_path": dict(
        n=N, d=D, q=Q, build_s=build_s, build_vps=N / build_s,
        build_again_s=build2_s, pack_s=pack_s, **{f"{key}_{f}": val
                          for key, r in results.items()
                          for f, val in r.items()},
    )}))
    print(json.dumps({"tail_m1000": tail}))
    print(json.dumps({"mutable": dict(dynamic=dyn, store=store)}))
    print(json.dumps({"out_of_core": dict(ooc, n=OOC_N, chunk=OOC_CHUNK,
                                          d=D, q=Q, models=models)}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"host_loop": hl}))
    print(json.dumps({"harness": harness}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"kernels": [{
        "name": "bucket_scan",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/bucket_scan_sm90.cu",
        "replaces": "vector_database_tpu/ops/pallas_knn.py:130",
        "also_replaces": ["vector_database_tpu/ops/pallas_knn.py:203",
                          "vector_database_tpu/ops/pallas_knn.py:274"],
        "launches": launches,
        "max_abs_err": full_err,
        **full_k,
        "plain_ms": p_ms,
        "pruned256": dict(pruned_k, max_abs_err=pr_err, plain_ms=pp_ms),
        "masked_launches_dynamic": dyn["launches"],
        "masked_launches_store": store["launches"],
        "masked_max_abs_err": dyn["kernel_masked_max_abs_err"],
        "masked_ms": dyn["kernel_masked_ms"],
        "masked_plain_ms": dyn["kernel_masked_plain_ms"],
        "masked_pruned256_max_abs_err":
            dyn["kernel_masked_pruned256_max_abs_err"],
        "masked_pruned256_ms": dyn["kernel_masked_pruned256_ms"],
        "masked_pruned256_plain_ms":
            dyn["kernel_masked_pruned256_plain_ms"],
        "m1000_launches": tail["launches"]["bucket_scan"],
        "m1000_max_abs_err": tail["bfloat16"]["max_abs_err"],
        "chunk_launches": ooc["launches"],
        "chunk_d96_ms": ooc["kernel"]["ms"],
        "chunk_d96_plain_ms": ooc["kernel"]["plain_ms"],
        "chunk_d96_bound_ms": ooc["kernel"]["bound_ms"],
        "chunk_d96_library_ms": ooc["kernel"]["library_ms"],
        "chunk_d96_max_abs_err": ooc["kernel"]["max_abs_err"],
        "chunk_d96_pruned256_ms": ooc["kernel"]["pruned256_ms"],
        "chunk_d96_pruned256_plain_ms": ooc["kernel"]["pruned256_plain_ms"],
        "chunk_d96_pruned256_bound_ms": ooc["kernel"]["pruned256_bound_ms"],
        "chunk_d96_pruned256_bound_by": ooc["kernel"]["pruned256_bound_by"],
        "chunk_d96_pruned256_library_ms":
            ooc["kernel"]["pruned256_library_ms"],
        "sharded_launches": mesh["launches"],
        "hostloop_launches": hl["launches"],
        "harness_launches": harness["launches"]["bucket_scan"],
        "bench_launches": bench["launches"],
    }, {
        "name": "bucket_scan_int8f",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/bucket_scan_sm90.cu",
        "replaces": "vector_database_tpu/ops/pallas_knn.py:130",
        "also_replaces": ["vector_database_tpu/ops/pallas_knn.py:203",
                          "vector_database_tpu/ops/pallas_knn.py:274"],
        "launches": i8f_launches,
        "max_abs_err": i8f_err,
        **i8f_k,
        "plain_ms": i8f_plain_ms,
        "pruned256": dict(i8p_k, max_abs_err=i8p_err, plain_ms=i8p_plain_ms),
        "masked_max_abs_err": i8m_err,
        "m1000_launches": tail["launches"]["bucket_scan_int8f"],
        "m1000_max_abs_err": tail["int8f"]["max_abs_err"],
        "harness_launches": harness["launches"]["bucket_scan_int8f"],
    }, {
        "name": "bucket_scan_i8",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/bucket_scan_i8.cu",
        "replaces": "vector_database_tpu/ops/pallas_knn.py:344",
        "launches": i8_launches,
        "max_abs_err": i8_err,
        **i8_k,
        "plain_ms": i8_plain_ms,
        "m1000_launches": tail["launches"]["bucket_scan_i8"],
        "m1000_max_abs_err": tail["int8"]["max_abs_err"],
        "harness_launches": harness["launches"]["bucket_scan_i8"],
        "uint8": u8,
    }, {
        "name": "probe_kernel_ab",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/probe_kernel_ab.cu",
        "replaces": "benchmarks/probe_kernel_ab.py:26",
        "launches": ab_launches,
        "max_abs_err": ab_err,
        **ab_n,
        "plain_ms": ab_plain_ms,
        "modes_ms": {r["mode"]: r["ms_per_1024q"] for r in ab},
        "split_q4096_ms": split,
        "m1000_max_abs_err": tail["probe_max_abs_err"],
    }, {
        "name": "segment_moments",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/segment_moments.cu",
        "replaces": None,  # the JAX build leaves phase 1 to XLA
        "build_launches": build_moments,
        **moments,
    }, {
        "name": "delta_knn",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/delta_knn.cu",
        "replaces": None,  # the JAX package merges the delta on the host
        "merge_launches_dynamic": dyn["delta_knn_launches"],
        **delta_knn,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
