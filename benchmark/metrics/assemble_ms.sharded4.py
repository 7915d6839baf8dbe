"""Host milliseconds of the result's assembly: the program's
``sdf.sharded.assemble`` spans (from the shards' launch returning to the
last block written into its slice of the (ni, nj, nk) result), summed a
call, median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.sharded.assemble"}, spans.host_ms)
