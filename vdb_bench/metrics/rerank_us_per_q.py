"""``rerank_us_per_q``: device time of the program's exact rerank (the
gather of the shortlisted rows, f32 distances, masks, the stable sort)
per query answered in the traced window, in microseconds: the operations
launched inside ``vdb_torch.knn.rerank`` (``layers``)."""

from vdb_bench.metrics import layers


def read(t):
    return layers.per_query_us(t, "vdb_torch.knn.rerank")
