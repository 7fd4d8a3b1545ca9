"""``program_idle_pct.build``: the share of a rebuild cell's traced window
in which no device operation runs while the host is inside the program's
spans (``layers.program_idle_ns``): the build's and the pack's host
syncs and Python."""

from vdb_bench.metrics import layers


def read(t):
    if t.kind != "rebuild" or t.window_s <= 0:
        return None
    idle = layers.program_idle_ns(t)
    return None if idle is None else 100.0 * idle / 1e9 / t.window_s
