"""Host milliseconds of the sharded host binning: the program's
``sdf.sharded.bin`` spans (the global band binning split by shard, the
per-shard CSR and the parity packed per block), summed a call, median over
the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.sharded.bin"}, spans.host_ms)
