"""``build_partition_ms``: device time of the build's partition (phase 3
of each level: child numbering, the node block, the stable partition and
the gathers of rows and ids by it) per rebuild operation traced, in
milliseconds: the operations launched inside
``vdb_torch.build.partition`` (``layers``)."""

from vdb_bench.metrics import layers


def read(t):
    return layers.per_operation_ms(t, "vdb_torch.build.partition")
