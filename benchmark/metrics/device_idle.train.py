"""The share of the profiled slice of the window in which no kernel or
copy ran on the card, in percent."""

from benchmark.lib.readers import idle_percent


def read(record):
    return idle_percent(record)
