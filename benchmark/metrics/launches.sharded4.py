"""Kernel launches of a ``generate_sdf_batch`` call over every card: the
change of the sum of the program's ``.launches`` counters over its
``sdf.generate_sdf_batch`` span, median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.generate_sdf_batch"}, spans.launches)
