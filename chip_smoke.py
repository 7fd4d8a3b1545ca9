#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each raises on failure; nothing is caught):

1. build the three CUDA kernels from ``vector_database_tpu_torch/csrc``,
   one ``nvcc`` each, all at once;
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
   the oracle;
6. the int8 and int8f packs of the same 10M x 96 leaf-major matrix: pack
   time, block bytes (half the bf16 pack's) and scale; ``PackedServer``
   full scans over both (recall@10 >= 0.90) and pruned int8f scans at
   probes 192/256/320; the exact int8 kernel bitwise equal to its plain
   version, the int8f route (full, and pruned to 256 blocks) within the
   bf16 tolerance, and the pruned int8f equalities of phase 4; both
   launch counts must rise;
7. the A/B scan probe: each mode bitwise equal to its plain version on
   small integers at 3 blocks, then its entry point times the four modes
   at 10M rows and 1024 queries (its JSON lines), and ``full`` is held
   bitwise to its plain version at that size, on small integers.

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
    cuda_build.build("bucket_scan", "bucket_scan_i8", "probe_kernel_ab")
    for mod in (bs, bi, pab):
        mod._load()
    print(f"[build] bucket_scan.cu, bucket_scan_i8.cu, probe_kernel_ab.cu "
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
    print(f"[int8] i8 kernel {Q}x{nb} blocks: kernel {i8_ms:.3f} ms, plain "
          f"{i8_plain_ms:.3f} ms, scores and block ids bitwise equal")
    del sk, ik, sp, ip

    qf = _scan_queries(p8f, qp)
    args8 = dict(m=p8f.m, bits=p8f.bits)
    acc_k = bs.bucket_scan(p8f.vn, p8f.vb, qf, **args8)
    acc_p = bs.bucket_scan_reference(p8f.vn, p8f.vb, qf, **args8)
    i8f_err, i8f_mis = _compare_acc(acc_k, acc_p, p8f, qf)
    i8f_ms = _ms(lambda: bs.bucket_scan(p8f.vn, p8f.vb, qf, **args8), REPS)
    i8f_plain_ms = _ms(lambda: bs.bucket_scan_reference(
        p8f.vn, p8f.vb, qf, **args8), REPS)
    print(f"[int8] int8f kernel {Q}x{nb} blocks: kernel {i8f_ms:.3f} ms, "
          f"plain {i8f_plain_ms:.3f} ms, max |score err| {i8f_err:.3g}, "
          f"block-id ties {i8f_mis:.2e}")
    order, bmap8 = _block_map(p8f, test, q_tile=q_tile, probes=max(PROBES))
    qfs = qf[order]
    pargs8 = dict(args8, bmap=bmap8, nprobe=min(256, nb), q_tile=q_tile)
    pk = bs.bucket_scan(p8f.vn, p8f.vb, qfs, **pargs8)
    pp = bs.bucket_scan_reference(p8f.vn, p8f.vb, qfs, **pargs8)
    i8p_err, i8p_mis = _compare_acc(pk, pp, p8f, qfs)
    i8p_ms = _ms(lambda: bs.bucket_scan(p8f.vn, p8f.vb, qfs, **pargs8), REPS)
    i8p_plain_ms = _ms(lambda: bs.bucket_scan_reference(
        p8f.vn, p8f.vb, qfs, **pargs8), REPS)
    print(f"[int8] int8f pruned 256 of {nb} blocks: kernel {i8p_ms:.3f} ms, "
          f"plain {i8p_plain_ms:.3f} ms, max |score err| {i8p_err:.3g}, "
          f"block-id ties {i8p_mis:.2e}")
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
    del full, pruned, srv, pruned8, pack, packs, p8, p8f, index
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
    print(f"[probe] full at {N} rows, {pab.Q} queries, small integers: "
          f"kernel {ab_ms:.3f} ms, plain {ab_plain_ms:.3f} ms, bitwise "
          "equal")
    del vn_ab, vb_ab, q_ab, qn_ab, ab_k, ab_p

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
        "int8f_launches": i8f_launches,
        "int8f_max_abs_err": i8f_err,
        "int8f_ms": i8f_ms,
        "int8f_plain_ms": i8f_plain_ms,
        "int8f_pruned256_ms": i8p_ms,
        "int8f_pruned256_plain_ms": i8p_plain_ms,
        "int8f_pruned256_max_abs_err": i8p_err,
    }, {
        "name": "bucket_scan_i8",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/bucket_scan_i8.cu",
        "replaces": "vector_database_tpu/ops/pallas_knn.py:344",
        "launches": i8_launches,
        "max_abs_err": i8_err,
        "ms": i8_ms,
        "plain_ms": i8_plain_ms,
    }, {
        "name": "probe_kernel_ab",
        "route": "cuda",
        "source": "vector_database_tpu_torch/csrc/probe_kernel_ab.cu",
        "replaces": "benchmarks/probe_kernel_ab.py:26",
        "launches": ab_launches,
        "max_abs_err": ab_err,
        "ms": ab_ms,
        "plain_ms": ab_plain_ms,
        "modes_ms": {r["mode"]: r["ms_per_1024q"] for r in ab},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
