"""Host milliseconds of the copy back's writes of the staged pieces into
the result (the host's first touch of it; the program's
``sdf.to_host.touch`` spans, summed a call), median over the profiled
calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.to_host.touch"}, spans.host_ms)
