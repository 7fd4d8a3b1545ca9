"""``scan_roofline_pct``: the scan kernels' share of their roofline over
the traced window. Time: the device time of the kernels named as the
scan (``work.SCAN_KERNELS``). Work: ``work.scan_ops`` and
``work.scan_bytes`` of the queries answered in the window."""

from vdb_bench.metrics import work


def read(t):
    if t.kind != "serve_batch" or not t.queries:
        return None
    scan_ns = sum(e - s for name, s, e in t.device_ops if work.is_scan(name))
    ops = work.scan_ops(t.queries, t.work)
    nbytes = work.scan_bytes(t.queries, t.requests, t.work)
    if scan_ns <= 0 or ops is None or nbytes is None:
        return None
    return 100.0 * work.bound_s(ops, nbytes) / (scan_ns / 1e9)
