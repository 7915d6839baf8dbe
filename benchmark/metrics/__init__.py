"""Per-layer metric readers, one file a metric, named as the metric.

Each defines ``read(record) -> float | None`` over the traced run's record:
``spans`` (``lib/trace.Spans``, None in an untraced run), ``profile``
(``lib/trace.Slice.summary()``, None where the trace holds no device
activity), ``shape`` (the grid's), ``platform`` and ``peaks`` (the card's
entry of ``lib/peaks.json``, None for a card it does not list). A reader
that finds nothing to read returns None, and the run leaves the metric
out.
"""
