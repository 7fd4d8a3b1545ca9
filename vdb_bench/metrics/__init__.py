"""Per-layer metrics: one reader a metric, ``<metric>.py``, each with a
``read(summary) -> float | None`` over a traced window
(``vdb_bench.trace.Summary``). A reader that finds nothing to read
returns None, and the run leaves the metric out of its line. ``work``
holds the peaks and the counts of a kernel's operations and bytes."""
