"""Host milliseconds of the halo exchanges: the program's
``sdf.sharded.halo`` ranges (one a transport ``extend``: the state halos
of the pyramid's rounds and the chamfer's), summed a call, median over the
profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.sharded.halo"}, spans.host_ms)
