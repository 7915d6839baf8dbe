"""Device milliseconds of K1's table in a step's forward (the program's
``sdf.dense.table`` span, CUDA events), median over the profiled steps."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.dense.table"}, spans.device_ms)
