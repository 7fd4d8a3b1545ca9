"""The card's peaks and the work of the scan, counted from the data's
own sizes: never from the pack's padded width, its waves or its tiles,
so the count reads the same work whatever implements the scan.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): bf16 989 TFLOP/s, int8 1,979 TOP/s, HBM3 3.35 TB/s.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

SCAN_KERNELS = ("bucket_scan",)  # the scan layer's kernels, by name


def is_scan(name: str) -> bool:
    return any(key in name for key in SCAN_KERNELS)


def scan_ops(queries: int, w: dict) -> float | None:
    """Multiply-adds x 2 that the scan needs: every query against every
    row (full) or against ``probes`` blocks of ``block`` rows (pruned)."""
    rows = w["n"]
    if w.get("probes") is not None:
        if not w.get("block"):
            return None
        rows = min(w["n"], w["probes"] * w["block"])
    return 2.0 * queries * rows * w["d"]


def scan_bytes(queries: int, requests: int, w: dict) -> float | None:
    """Bytes the scan needs at least: each request reads the rows it
    scores once in bf16, the queries in bf16, and writes one float32
    minimum a bucket for each query."""
    rows = w["n"]
    if w.get("probes") is not None:
        if not w.get("block"):
            return None
        rows = min(w["n"], w["probes"] * w["block"])
    return (requests * rows * w["d"] * 2.0 + queries * w["d"] * 2.0
            + queries * w["m"] * 4.0)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the slower of the two peaks."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
