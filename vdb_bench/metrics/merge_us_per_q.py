"""``merge_us_per_q``: device time of ``DynamicIndex.merge_delta`` (the
delta's exact distances, its ``k`` best, the stable merge with the main
segment's top ``k``) per query answered in the churn cell's traced
window, in microseconds: the operations launched inside
``vdb_torch.dynamic.merge`` (``layers``)."""

from vdb_bench.metrics import layers

SPAN = "vdb_torch.dynamic.merge"


def read(t):
    if t.kind != "churn" or not t.queries:
        return None
    ns = (layers.layer_ns(t) or {}).get(SPAN)
    return None if ns is None else ns / 1e3 / t.queries
