"""Host milliseconds of the binning's blob: its pack into pinned memory and
the enqueue of its copy to the card (the program's ``sdf.bin.upload``
span), median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.bin.upload"}, spans.host_ms)
