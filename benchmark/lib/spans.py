"""The program's own spans (``sdfgenfast_tpu_torch.tracing``), one group a
call.

The program records its spans while ``torch.profiler`` is on, so a traced
run's ring holds the spans of the profiled slice's calls or steps; the
readers read it after the window. Spans are grouped by their root, the
span that opened the call into the program: ``bin_mesh``,
``make_level_set3`` and ``to_host`` each open one in a traced call of the
``generate`` mix, the step's forward and its backward in ``train``. A
program without the tracer, or a slice that recorded nothing, gives no
spans, and the readers return None.
"""

from __future__ import annotations

import collections
import statistics


def records():
    """The finished spans of the program's ring ([] without a tracer)."""
    try:
        from sdfgenfast_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def host_ms(span, group):
    return span.host_ms


def device_ms(span, group):
    return span.device_ms


def launches(span, group):
    return span.launches


def device_self(child: str):
    """A span's device milliseconds less those of its children named
    `child` (None for a span without device time)."""
    def value(span, group):
        if span.device_ms is None:
            return None
        return span.device_ms - sum(
            c.device_ms or 0.0 for c in group
            if c.parent == span.id and c.name == child)
    return value


def median(names, value, spans=None):
    """The median over the calls that hold spans named in `names` of the
    sum of ``value(span, the call's spans)`` over those spans; a call where
    one of them has no value is left out. None without such a call."""
    groups = collections.defaultdict(list)
    for s in records() if spans is None else spans:
        groups[s.root].append(s)
    sums = []
    for group in groups.values():
        vals = [value(s, group) for s in group if s.name in names]
        if vals and all(v is not None for v in vals):
            sums.append(sum(vals))
    return statistics.median(sums) if sums else None
