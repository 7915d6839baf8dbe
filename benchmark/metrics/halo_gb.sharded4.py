"""Gigabytes (1e9 bytes) that the halo exchanges write: the ``bytes``
count of the program's ``sdf.sharded.halo`` ranges (each extended block,
each fill and each neighbour's planes sent from another device), summed a
call, median over the profiled calls."""

from benchmark.lib import spans


def _gb(span, group):
    n = getattr(span, "counts", {}).get("bytes")
    return None if n is None else n / 1e9


def read(record):
    return spans.median({"sdf.sharded.halo"}, _gb)
