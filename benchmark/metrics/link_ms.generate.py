"""Device milliseconds of the copy back's staging copies over the link (the
program's ``sdf.to_host.link`` spans on the side stream, CUDA events,
summed a call), median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.to_host.link"}, spans.device_ms)
