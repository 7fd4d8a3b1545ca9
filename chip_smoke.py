#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each raises on failure; nothing is caught):

1. build the three CUDA sources from ``vector_database_tpu_torch/csrc``
   (``bucket_scan_sm90.cu``, the scan of bf16 and int8f packs, and
   ``probe_kernel_ab.cu``, the A/B probe, both on the Hopper skeleton of
   ``sm90.cuh``; ``bucket_scan_i8.cu``, the exact int8 scan), one
   ``nvcc`` each, all at once;
2. hold the kernel to the exact oracle where the scan is exact
   (n <= buckets: every row owns a bucket);
3. the main path at 10M x 96 clustered rows (the bench recipe: n/1000
   centres uniform in [-1, 1], sigma 0.05): fused build (leaf 16), pack
   (4096 buckets), ``PackedServer`` full scan and pruned scans at probes
   192/256/320, q=4096, recall@10 against the exact oracle on 1024
   queries; the bf16 kernel's launch count must rise;
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
   probes 192/256/320; the exact int8 kernel bitwise equal to its plain
   version, the int8f route of ``bucket_scan_sm90.cu`` (full, and pruned
   to 256 blocks) within the bf16 tolerance (also on an int8f pack with a
   seeded 1% of rows masked), and the pruned int8f equalities of phase 4;
   both launch counts must rise;
7. the A/B scan probe: each mode bitwise equal to its plain version on
   small integers at 3 blocks, then its entry point times the four modes
   at 10M rows and 1024 queries (its JSON lines), and ``full`` is held
   bitwise to its plain version at that size, on small integers; then
   the four modes are timed again at the serving batch, q=4096, beside
   the scan kernel of phase 4 (the ``split_q4096_ms`` field);
8. the mutable collections. (a) ``DynamicIndex`` over the same 10M x 96
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

It prints the card's name and power limit, one JSON line of phase-8
results, one JSON line of kernel results (each kernel with its time, its
plain version's, its bound from this run's shapes and the card's
published peaks, the library yardstick, TFLOP/s and share of the bound),
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits non-zero and prints no result.
"""

import json
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
STORE_DOCS, STORE_TEXTS, STORE_ADD, SEARCH_Q = 200, 5000, 1000, 64
REPS = 3
DEVICE = "cuda"
# NVIDIA H100 SXM published peaks (dense): bf16 and int8 tensor cores, HBM
PEAK_BF16, PEAK_INT8, PEAK_HBM = 989e12, 1979e12, 3.35e12
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
    block (int8 x int8 -> int32 products), scaled to ``blocks``; None
    where the call does not take these shapes on this build."""
    import torch

    try:
        t = _ms(lambda: [torch._int_mm(qi, vb[b]) for b in
                         range(LIB_BLOCKS)], REPS)
    except RuntimeError:
        return None
    return t * blocks / LIB_BLOCKS


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

    out = {}
    train, test, centers, g = _clustered(dev, N, SEED)
    torch.cuda.synchronize()
    bs.bucket_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    idx = DynamicIndex(train, leaf_size=LEAF, device=dev)
    torch.cuda.synchronize()
    out["construct_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.knn(test, K, packed=True)
    out["first_packed_s"] = time.perf_counter() - t0
    base = idx._packed_base[1]
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
    if idx._delta_size() != ADD or len(idx) != N - REMOVE + ADD:
        raise AssertionError("the adds did not stay in the delta")

    t0 = time.perf_counter()
    ids, d2 = idx.knn(test, K, packed=True)
    out["first_packed_after_remove_s"] = time.perf_counter() - t0
    if idx._packed_base[1] is not base or idx._packed[1].vb is not base.vb:
        raise AssertionError("the removal rebuilt the base pack")
    out["packed_ms"] = _host_ms(lambda: idx.knn(test, K, packed=True), REPS)
    q_dev = torch.as_tensor(test, device=dev)
    out["delta_merge_ms"] = _host_ms(
        lambda: idx.merge_delta(q_dev, ids, d2, K), REPS)
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

    masked = idx._packed[1]
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
    out["launches"] = bs.bucket_scan.LAUNCHES
    if out["launches"] < 1:
        raise AssertionError("DynamicIndex never launched bucket_scan")
    print(f"[dynamic] compact {out['compact_s']:.3f} s, then a packed "
          f"batch {out['packed_after_compact_s']:.3f} s; bucket_scan "
          f"launches {out['launches']}")
    del idx

    # the kernel alone on the masked norm row, full and pruned
    d_pad = masked.vb.shape[1]
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
    from vector_database_tpu_torch.ops import bucket_scan as bs

    out = {}
    n = STORE_DOCS * STORE_TEXTS
    train, test, centers, g = _clustered(dev, n, SEED + 3)
    host = train.cpu().numpy()
    bs.bucket_scan.LAUNCHES = 0
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
    out["launches"] = bs.bucket_scan.LAUNCHES
    if out["launches"] < 1:
        raise AssertionError("DocumentStore never launched bucket_scan")
    print(f"[store] {STORE_ADD} add_text rows served from the delta at "
          f"distance 0 ({out['delta_packed_s']:.3f} s for the batch), no "
          f"rebuild; bucket_scan launches {out['launches']}")
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
    from vector_database_tpu_torch.ops import cuda_build
    from vector_database_tpu_torch.ops.packed_knn import (
        _block_map,
        _scan_queries,
    )
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
    t0 = time.perf_counter()
    cuda_build.build("bucket_scan_sm90", "bucket_scan_i8", "probe_kernel_ab")
    for mod in (bs, bi, pab):
        mod._load()
    print(f"[build] bucket_scan_sm90.cu, bucket_scan_i8.cu, "
          f"probe_kernel_ab.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

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

    bs.bucket_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    index = build_index_fused(train, leaf_size=LEAF)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del train
    print(f"[main] build {N}x{D} leaf {LEAF}: {build_s:.3f} s, "
          f"{N / build_s:.1f} vectors/s, depth {index.depth}, "
          f"{index.num_leaves} leaves")

    t0 = time.perf_counter()
    pack = pack_database(index.vectors, buckets=BUCKETS)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    nb = pack.vb.shape[0]
    print(f"[main] pack: {pack_s:.3f} s, nb={nb} block={pack.block} "
          f"m={pack.m} d_pad={pack.vb.shape[1]} bits={pack.bits}")

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
    launches = bs.bucket_scan.LAUNCHES
    if launches < 1:
        raise AssertionError("the main path never launched bucket_scan")
    print(f"[main] bucket_scan launches on the main path: {launches}")

    # ---- 4. kernel vs plain at the main path's shapes -------------------
    d_pad, q_tile = pack.vb.shape[1], 512
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
    bs.bucket_scan.LAUNCHES = bs.bucket_scan.LAUNCHES_INT8F = 0
    bi.bucket_scan_i8.LAUNCHES = 0
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
    i8_launches = bi.bucket_scan_i8.LAUNCHES
    i8f_launches = bs.bucket_scan.LAUNCHES_INT8F
    if i8_launches < 1 or i8f_launches < 1:
        raise AssertionError(f"int8 path launches: i8 {i8_launches}, "
                             f"int8f {i8f_launches}")
    print(f"[int8] launches on the int8 paths: bucket_scan_i8 "
          f"{i8_launches}, bucket_scan int8f {i8f_launches}, bf16 "
          f"{bs.bucket_scan.LAUNCHES}")

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
    print(f"[int8] i8 kernel {Q}x{nb} blocks: kernel {i8_ms:.3f} ms, plain "
          f"{i8_plain_ms:.3f} ms, scores and block ids bitwise equal; "
          f"bound {i8_k['bound_ms']:.3f} ms ({i8_k['bound_by']}), "
          f"{i8_k['pct_of_bound']:.1f}% of bound; torch._int_mm "
          f"{i8_k['library_ms']}")
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

    # ---- 7. the A/B scan probe -------------------------------------------
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

    # ---- 8. the mutable collections ----------------------------------------
    dyn = _dynamic_phase(dev)
    store = _store_phase(dev)

    print(json.dumps({"main_path": dict(
        n=N, d=D, q=Q, build_s=build_s, build_vps=N / build_s,
        pack_s=pack_s, **{f"{key}_{f}": val
                          for key, r in results.items()
                          for f, val in r.items()},
    )}))
    print(json.dumps({"mutable": dict(dynamic=dyn, store=store)}))
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
    }, {
        "name": "bucket_scan_i8",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/bucket_scan_i8.cu",
        "replaces": "vector_database_tpu/ops/pallas_knn.py:344",
        "launches": i8_launches,
        "max_abs_err": i8_err,
        **i8_k,
        "plain_ms": i8_plain_ms,
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
