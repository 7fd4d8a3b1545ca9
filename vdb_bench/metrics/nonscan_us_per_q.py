"""``nonscan_us_per_q``: device time outside the scan kernels (selection,
shortlist, rerank, copies) per query answered in the traced window, in
microseconds."""

from vdb_bench.metrics import work


def read(t):
    if t.kind != "serve_batch" or not t.queries or not t.device_ops:
        return None
    other_ns = sum(e - s for name, s, e in t.device_ops
                   if not work.is_scan(name))
    return other_ns / 1e3 / t.queries
