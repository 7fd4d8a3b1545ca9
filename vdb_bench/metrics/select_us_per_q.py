"""``select_us_per_q``: device time of the program's shortlist (query
preparation, the stable sort of the buckets, block-id decoding; not the
scan kernel, which its own ``vdb_torch.knn.scan`` span holds) per query
answered in the traced window, in microseconds: the operations launched
inside ``vdb_torch.knn.shortlist`` (``layers``)."""

from vdb_bench.metrics import layers


def read(t):
    return layers.per_query_us(t, "vdb_torch.knn.shortlist")
