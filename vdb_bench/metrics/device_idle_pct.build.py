"""``device_idle_pct.build``: the share of a rebuild cell's traced window
in which no device operation runs."""


def read(t):
    if t.kind != "rebuild" or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
