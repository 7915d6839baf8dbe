"""Device milliseconds of the band in ``make_level_set3``: the vertex gather,
K2, the untile and the freeze mask (the program's ``sdf.band`` span,
CUDA events), median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.band"}, spans.device_ms)
