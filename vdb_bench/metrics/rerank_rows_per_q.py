"""``rerank_rows_per_q``: the shortlist rows the exact rerank gathers for
each query, counted where it gathers them (today ``k`` times the buckets
kept per neighbour times the rows a bucket holds in a block; a shortlist
that dropped or merged candidates would read less): the program's
counters ``knn.shortlist_rows`` over ``knn.shortlist_queries``, over the
whole run, on a traced serving window that ran on a device. None where
the program keeps no such counters."""

from vdb_bench.metrics import layers


def read(t):
    if t.kind != "serve_batch" or not t.device_ops:
        return None
    c = layers.counters()
    if not c or not c.get("knn.shortlist_queries"):
        return None
    return c["knn.shortlist_rows"] / c["knn.shortlist_queries"]
