"""``wave_fill_pct``: the share of the serving front end's wave slots that
real queries filled (``PackedServer.query`` pads the last wave of a
request): the program's counters ``serve.queries`` over ``serve.slots``,
over the whole run, on a traced window that ran on a device."""

from vdb_bench.metrics import layers


def read(t):
    if t.kind != "serve_batch" or not t.device_ops:
        return None
    c = layers.counters()
    if not c or not c.get("serve.slots"):
        return None
    return 100.0 * c["serve.queries"] / c["serve.slots"]
