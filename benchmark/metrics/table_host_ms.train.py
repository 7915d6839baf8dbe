"""Host milliseconds of K1's table in a step's forward: the vertex gather
and the torch ops of ``ops/dense.sep_table`` enqueued (the program's
``sdf.dense.table`` span), median over the profiled steps."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.dense.table"}, spans.host_ms)
