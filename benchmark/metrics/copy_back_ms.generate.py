"""Host milliseconds of ``upload.to_host`` of the finished grid (the copy
back, after the device is done), median over the traced calls."""

from benchmark.lib.readers import span_median


def read(record):
    return span_median(record, "copy_back")
