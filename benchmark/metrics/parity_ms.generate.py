"""Host milliseconds of the x-ray parity inside ``pipeline.bin_mesh`` (the
program's ``sdf.bin.parity`` span), median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.bin.parity"}, spans.host_ms)
