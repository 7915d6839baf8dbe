"""Device milliseconds of the far field's torch glue: the program's
``sdf.far_field`` span (the pyramid with its axis permutes; CUDA events)
less its ``sdf.k3`` spans (K3's calls), median over the profiled calls."""

from benchmark.lib import spans


def read(record):
    return spans.median({"sdf.far_field"}, spans.device_self("sdf.k3"))
