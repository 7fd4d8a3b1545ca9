"""``mutation_ms``: host time a churn cycle spends in ``DynamicIndex``'s
mutation bookkeeping, in milliseconds: the union of its ``add``,
``remove`` (``remove_ids``), ``main_view`` (the main view and its masked
pack, rebuilt after a removal) and ``delta_view`` spans over the traced
window (nested spans counted once), over the cycles traced."""

SPANS = ("vdb_torch.dynamic.add", "vdb_torch.dynamic.remove",
         "vdb_torch.dynamic.main_view", "vdb_torch.dynamic.delta_view")


def read(t):
    if t.kind != "churn" or not t.requests:
        return None
    t0, t1 = t.window_ns
    spans = sorted((max(s, t0), min(e, t1)) for name, s, e in t.host_ops
                   if name in SPANS)
    if not spans:
        return None
    total, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6 / t.requests
