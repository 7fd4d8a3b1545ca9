"""The benchmark of ``vector_database_tpu_torch`` on NVIDIA H100 cards.

``python -m vdb_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line
(``README.md``). Everything that belongs to one configuration, cell,
traffic kind or per-layer metric is a file of its own, found by the name
that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment (sizes, metric, pack, source);
- ``workloads/<cell>.json``: a cell and the limits of its ``correct``;
- ``traffic/<mix>.json``: a traffic mix's parameters, read by the
  generator of its kind, ``traffic/<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader.
"""
