"""Device milliseconds of a step's ``torch.autograd.grad`` (R1/R1b, the
recompute's backward; CUDA events around it), median over the traced
steps."""

from benchmark.lib.readers import span_median


def read(record):
    return span_median(record, "backward", device=True)
