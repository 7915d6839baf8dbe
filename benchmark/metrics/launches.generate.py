"""Kernel launches of a ``make_level_set3`` call: the change of the sum of
the program's eight ``.launches`` counters over its ``sdf.make_level_set3``
span, median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.make_level_set3"}, spans.launches)
