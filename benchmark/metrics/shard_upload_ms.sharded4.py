"""Host milliseconds of the shards' uploads of their binned arrays: the
program's ``sdf.sharded.upload`` ranges (one a host array sent to a
shard's device), summed a call, median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.sharded.upload"}, spans.host_ms)
