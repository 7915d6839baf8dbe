"""The device trace of a slice of the window (``torch.profiler``) and the
spans the benchmark records around its calls into the program.

:class:`Slice` profiles a stretch of calls inside a ``bench.slice`` range.
Its :meth:`Slice.summary` gives the slice's length on the profiler's own
clock, the union of the device's kernel and copy intervals inside it (the
busy time; ``union_us`` is a frozen copy of
``sdfgenfast_tpu_torch.tools.profile_stages.union_us``), each device
operation's time by name, and the idle gaps between device intervals, each
named by the innermost host range the profiler saw at the gap's middle
under the benchmark's outermost ``bench.`` range.
"""

from __future__ import annotations

import bisect
import collections
import re
import statistics
import time

import torch


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + hi - lo


def merged(spans):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list and namespaces, cut to 80
    characters (torch's template names run to a thousand)."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(noise, "")
    name = name.split("(")[0]
    name = re.sub(r"<.*>", "<>", name) if len(name) > 80 else name
    return name[:80]


class Spans:
    """Milliseconds of named spans, one entry a call."""

    def __init__(self):
        self.ms = collections.defaultdict(list)

    def add(self, name: str, ms: float) -> None:
        self.ms[name].append(ms)

    def median(self, name: str):
        vals = self.ms.get(name)
        return statistics.median(vals) if vals else None


class Slice:
    """``torch.profiler`` over the calls made inside ``with Slice(dev):``;
    the calls end synchronised. `calls` counts them."""

    def __init__(self, device):
        self.device = device
        self.calls = 0
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function("bench.slice")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.host_s = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def summary(self):
        """None where the trace holds no device activity; else a dict:
        window_us, busy_us, calls, kernels {name: us}, gaps {name: us}."""
        from torch.autograd import DeviceType

        events = self._prof.events()
        window = [e for e in events if e.name == "bench.slice"]
        # the device-side copies of the benchmark's own ranges are no
        # device work
        on_device = [e for e in events if e.device_type == DeviceType.CUDA
                     and not e.name.startswith("bench.")]
        device = [(e.time_range.start, e.time_range.end) for e in on_device
                  if e.time_range.end > e.time_range.start]
        if not window or not device:
            return None
        lo, hi = window[0].time_range.start, window[0].time_range.end
        device = [(max(a, lo), min(b, hi)) for a, b in device
                  if b > lo and a < hi]
        busy = merged(device)
        kernels = collections.Counter()
        for e in on_device:
            span = e.time_range.end - e.time_range.start
            kernels[short_name(e.name)] += span
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in events if e.device_type == DeviceType.CPU
                       and e.name != "bench.slice"), key=lambda r: r[0])
        starts = [r[0] for r in host]
        gaps = collections.Counter()
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_host_at(host, starts, (a + b) / 2)] += b - a
        return {"window_us": hi - lo, "busy_us": union_us(busy),
                "calls": self.calls, "kernels": dict(kernels),
                "gaps": dict(gaps)}


def _host_at(host, starts, t, reach: int = 4000) -> str:
    """The outermost ``bench.`` range and the innermost range of `host`
    ((start, end, name) sorted by start; `starts` their starts) that hold
    time `t`, among the `reach` ranges that start last before it."""
    outer = inner = None
    depth = None
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - reach):i]):
        if b < t:
            continue
        if name.startswith("bench."):
            outer = name
        if depth is None or b - a < depth:
            inner, depth = name, b - a
    if inner is None:
        return "host, outside any range"
    if outer is None or outer == inner:
        return inner
    return f"{outer} > {inner}"


def top(counter: dict, n: int = 10):
    """The `n` largest entries as [[name, seconds], ...] (from us)."""
    rows = sorted(counter.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in rows]
