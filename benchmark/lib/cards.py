"""The device trace of a slice of the window over several cards
(``torch.profiler``), summed per card.

:class:`Slice` is ``lib/trace.Slice`` with every card synchronised where
that one synchronises its one. :func:`summary` splits the trace's device
intervals by card: each card's busy time is the union of its own kernel
and copy intervals inside the slice, and ``busy_us`` is the mean over the
cards, so that the idle share read from it is a card's and not four cards'
work laid on one timeline. Device operations are summed over the cards;
each card's idle gaps are named as ``lib/trace.py`` names them (the
innermost host range at the gap's middle under the benchmark's outermost
``bench.`` range) and summed by name over the cards. The profiler's copies
of host ranges onto the device timeline (the benchmark's ``bench.`` ranges
and the program's ``sdf.`` ranges) are no device work.
"""

from __future__ import annotations

import collections

import torch

from benchmark.lib import trace

ANNOTATIONS = ("bench.", "sdf.")


class Slice(trace.Slice):
    """``torch.profiler`` over the calls made inside ``with
    Slice(devices):``; every card is synchronised at both ends."""

    def __init__(self, devices):
        super().__init__(devices[0])
        self.devices = list(devices)

    def __enter__(self):
        for d in self.devices:
            torch.cuda.synchronize(d)
        return super().__enter__()

    def __exit__(self, *exc):
        for d in self.devices:
            torch.cuda.synchronize(d)
        return super().__exit__(*exc)

    def summary(self):
        return summary(self._prof.events(), self.calls,
                       [d.index for d in self.devices])


def summary(events, calls: int, cards):
    """None where the trace holds no device activity on the cards; else a
    dict: window_us, busy_us (the cards' mean), calls, kernels {name: us}
    (summed over the cards), gaps {name: us} (summed over the cards) and
    cards {index: busy_us}. `events` are the profiler's events (``name``,
    ``device_type``, ``device_index``, ``time_range``); `cards` the CUDA
    device indices of the slice."""
    from torch.autograd import DeviceType

    window = [e for e in events if e.name == "bench.slice"]
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.device_index in cards
                 and not e.name.startswith(ANNOTATIONS)]
    if not window or not on_device:
        return None
    lo, hi = window[0].time_range.start, window[0].time_range.end
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name != "bench.slice"), key=lambda r: r[0])
    starts = [r[0] for r in host]
    kernels = collections.Counter()
    for e in on_device:
        kernels[trace.short_name(e.name)] += (e.time_range.end
                                              - e.time_range.start)
    gaps = collections.Counter()
    busy = {}
    for card in cards:
        spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
                 for e in on_device if e.device_index == card
                 and e.time_range.end > e.time_range.start
                 and e.time_range.end > lo and e.time_range.start < hi]
        merged = trace.merged(spans)
        busy[card] = trace.union_us(merged)
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[trace._host_at(host, starts, (a + b) / 2)] += b - a
    return {"window_us": hi - lo, "busy_us": sum(busy.values()) / len(cards),
            "calls": calls, "kernels": dict(kernels), "gaps": dict(gaps),
            "cards": busy}
