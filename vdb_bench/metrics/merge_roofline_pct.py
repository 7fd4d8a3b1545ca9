"""``merge_roofline_pct``: the delta merge's share of its roofline over
the churn cell's traced window: the least time its work takes, over the
device time under ``vdb_torch.dynamic.merge`` (``merge_us_per_q``'s).

The work is counted from the data's sizes, whatever implements it: each
request's ``Q`` queries against the ``R`` live delta rows (not the padded
capacity) in the difference form, ``3 Q D R`` operations (a subtraction, a
multiplication and an addition a pair and dimension) at the float32 peak
outside the tensor cores, since the values must stay those of the
difference form; and ``(Q D + R D) 4 + Q k 12`` bytes (queries and delta
rows read once in float32, the main segment's ``k`` best read and the
merged ``k`` written, 4-byte distance and 8-byte id each) at the HBM
peak."""

from vdb_bench.metrics import layers, work
from vdb_bench.metrics.merge_us_per_q import SPAN

PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def merge_ops(q: int, r: int, d: int) -> float:
    return 3.0 * q * d * r


def merge_bytes(q: int, r: int, d: int, k: int) -> float:
    return (q * d + r * d) * 4.0 + q * k * 12.0


def bound_s(q: int, r: int, d: int, k: int) -> float:
    """The least time one merge of ``q`` queries over ``r`` rows takes."""
    return max(merge_ops(q, r, d) / PEAK_F32_FLOPS,
               merge_bytes(q, r, d, k) / work.PEAK_HBM_BYTES)


def read(t):
    merges = t.work.get("merges") if t.kind == "churn" else None
    if not merges:
        return None
    ns = (layers.layer_ns(t) or {}).get(SPAN)
    if not ns:
        return None
    least = sum(bound_s(q, r, t.work["d"], t.work["k"]) for q, r in merges)
    return 100.0 * least / (ns / 1e9)
