"""The 95th percentile of the host wall of the traced run's calls, from
mesh arrays in to the NumPy grid out (``statistics.quantiles`` in 20
parts). A closed loop with one caller runs at the system's capacity, where
the tail follows the host's load from run to run."""

import statistics


def read(record):
    spans = record.get("spans")
    calls = None if spans is None else spans.ms.get("call")
    if not calls or len(calls) < 2:
        return None
    return statistics.quantiles(calls, n=20)[18]
