"""``scan_i8_roofline_pct``: the integer scan kernel's share of its
roofline over the traced window. Time: the device time of the kernels
whose name holds ``bucket_scan_i8``. Work, counted from the data's sizes
(never the pack's padded width, its waves or its tiles): ``2 Q N D``
int8 operations at the int8 peak, and the bytes each request needs at
least, its ``N x D`` one-byte rows read once, its queries' ``Q x D``
bytes, and an int32 score and an int32 block id written for each query
and bucket (``Q m 8``), at the HBM peak (``work.py``'s peaks)."""

from vdb_bench.metrics import work

KERNEL = "bucket_scan_i8"


def scan_i8_ops(queries: int, w: dict) -> float:
    """Multiply-adds x 2: every query against every row."""
    return 2.0 * queries * w["n"] * w["d"]


def scan_i8_bytes(queries: int, requests: int, w: dict) -> float:
    return (requests * w["n"] * w["d"] * 1.0 + queries * w["d"] * 1.0
            + queries * w["m"] * 8.0)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the slower of the two peaks."""
    return max(ops / work.PEAK_INT8_OPS, nbytes / work.PEAK_HBM_BYTES)


def read(t):
    if t.kind != "serve_batch" or not t.queries or \
            t.work.get("probes") is not None:
        return None
    ns = sum(e - s for name, s, e in t.device_ops if KERNEL in name)
    if ns <= 0:
        return None
    least = bound_s(scan_i8_ops(t.queries, t.work),
                    scan_i8_bytes(t.queries, t.requests, t.work))
    return 100.0 * least / (ns / 1e9)
