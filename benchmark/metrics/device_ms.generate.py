"""Device milliseconds of ``pipeline.make_level_set3(binned=)`` (CUDA events
around it), median over the traced calls."""

from benchmark.lib.readers import span_median


def read(record):
    return span_median(record, "device", device=True)
