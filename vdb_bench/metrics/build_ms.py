"""``build_ms``: the median of the rebuild window's ``build`` spans (the host
clock around the program's build call, ending in a synchronise), in
milliseconds; the operations inside the traced seconds are left out."""

import statistics


def read(t):
    spans = t.spans.get("build") if t.kind == "rebuild" else None
    return statistics.median(spans) * 1e3 if spans else None
