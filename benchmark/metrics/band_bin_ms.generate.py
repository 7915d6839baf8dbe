"""Host milliseconds of the band binning and its CSR inside
``pipeline.bin_mesh`` (the program's ``sdf.bin.band`` and ``sdf.bin.csr``
spans, summed a call), median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.bin.band", "sdf.bin.csr"}, spans.host_ms)
