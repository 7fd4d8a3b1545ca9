#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each raises on failure; nothing is caught):

1. build the CUDA kernel from ``vector_database_tpu_torch/csrc``;
2. hold the kernel to the exact oracle where the scan is exact
   (n <= buckets: every row owns a bucket);
3. the main path at 10M x 96 clustered rows (the bench recipe: n/1000
   centres uniform in [-1, 1], sigma 0.05): fused build (leaf 16), pack
   (4096 buckets), ``PackedServer`` full scan and pruned scans at probes
   192/256/320, q=4096, recall@10 against the exact oracle on 1024
   queries; the kernel's launch count must rise;
4. the kernel against its plain torch version at the main path's shapes
   (full and pruned), with the two bitwise equalities of the pruned
   path (probes = nb equals the full scan; runtime probes equal static);
5. exact radius ``search``/``knn`` through the tree at 1M x 8 against
   the oracle.

It prints the card's name and power limit, one JSON line of kernel
results, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits non-zero and prints no result.
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
REPS = 3
DEVICE = "cuda"


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
    from vector_database_tpu_torch.ops import bucket_scan as bs
    from vector_database_tpu_torch.ops.packed_knn import _block_map
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
    bs._load()
    print(f"[build] bucket_scan.cu built and loaded in "
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
    g = torch.Generator(device=dev).manual_seed(SEED)
    c = N // 1000
    centers = torch.rand((c, D), generator=g, device=dev) * 2 - 1
    train = torch.randn((N, D), generator=g, device=dev).mul_(0.05)
    train += centers[torch.randint(0, c, (N,), generator=g, device=dev)]
    test = centers[torch.randint(0, c, (Q,), generator=g, device=dev)]
    test = test + 0.05 * torch.randn((Q, D), generator=g, device=dev)
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
    print(f"[kernel] full scan {Q}x{nb} blocks: kernel {k_ms:.3f} ms, "
          f"plain {p_ms:.3f} ms, max |score err| {full_err:.3g}, "
          f"block-id ties {full_mis:.2e}")

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
    print(f"[kernel] pruned 256 of {nb} blocks: kernel {pk_ms:.3f} ms, "
          f"plain {pp_ms:.3f} ms, max |score err| {pr_err:.3g}, "
          f"block-id ties {pr_mis:.2e}")

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
    del pack, index, acc_k, acc_p, pk, pp, acc_all

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

    print(json.dumps({"main_path": dict(
        n=N, d=D, q=Q, build_s=build_s, build_vps=N / build_s,
        pack_s=pack_s, **{f"{key}_{f}": val
                          for key, r in results.items()
                          for f, val in r.items()},
    )}))
    print(json.dumps({"kernels": [{
        "name": "bucket_scan",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/bucket_scan.cu",
        "replaces": "vector_database_tpu/ops/pallas_knn.py:130",
        "also_replaces": ["vector_database_tpu/ops/pallas_knn.py:203",
                          "vector_database_tpu/ops/pallas_knn.py:274"],
        "launches": launches,
        "max_abs_err": full_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "pruned256_ms": pk_ms,
        "pruned256_plain_ms": pp_ms,
        "pruned256_max_abs_err": pr_err,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
