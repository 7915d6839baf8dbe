"""Mvoxels a second over the traced run's calls: the grid's cells times the
calls, over the sum of the calls' host walls (mesh arrays in to the NumPy
grid out). The traced calls synchronise between their three parts and
eight of them run under the profiler, so this reads somewhat below the
untraced rate. It is a per-layer metric: on the binned path the rate
follows the host's load from run to run by more than an end-to-end bound
may hold."""

import math


def read(record):
    spans = record.get("spans")
    calls = None if spans is None else spans.ms.get("call")
    shape = record.get("shape")
    if not calls or shape is None or sum(calls) <= 0:
        return None
    return math.prod(shape) * len(calls) / (sum(calls) / 1e3) / 1e6
