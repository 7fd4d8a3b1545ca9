"""``delta_fill_pct``: the share of ``DynamicIndex``'s padded delta that
live rows filled when merged (the delta is padded to a power-of-two
capacity): the program's counters ``dynamic.delta_rows`` over
``dynamic.delta_slots``, over the whole run, on a traced churn window
that ran on a device."""

from vdb_bench.metrics import layers


def read(t):
    if t.kind != "churn" or not t.device_ops:
        return None
    c = layers.counters()
    if not c or not c.get("dynamic.delta_slots"):
        return None
    return 100.0 * c["dynamic.delta_rows"] / c["dynamic.delta_slots"]
