"""Host milliseconds of ``pipeline.bin_mesh(device=)`` (the parity, the band
binning and the blob's upload), median over the traced calls."""

from benchmark.lib.readers import span_median


def read(record):
    return span_median(record, "bin")
