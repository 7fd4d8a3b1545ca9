"""``build_moments_ms``: device time of the build's moments pass (phase 1
of each level: the prefix sums over transposed column chunks and the
split dimension from them) per rebuild operation traced, in
milliseconds: the operations launched inside
``vdb_torch.build.moments`` (``layers``)."""

from vdb_bench.metrics import layers


def read(t):
    return layers.per_operation_ms(t, "vdb_torch.build.moments")
