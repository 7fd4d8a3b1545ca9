"""``program_idle_pct.serve``: the share of a serving cell's traced window
in which no device operation runs while the host is inside the program's
spans (``layers.program_idle_ns``): the device waiting on the program's
own host work, not on the client's or the benchmark's."""

from vdb_bench.metrics import layers


def read(t):
    if t.kind != "serve_batch" or t.window_s <= 0:
        return None
    idle = layers.program_idle_ns(t)
    return None if idle is None else 100.0 * idle / 1e9 / t.window_s
