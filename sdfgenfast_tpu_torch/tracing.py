"""Spans at the layer boundaries of the main path, kept in memory.

A span records only while tracing is on: between :func:`enable` and
:func:`disable`, or on a thread where a ``torch.profiler`` session is
active. Off, :func:`span` is one check and returns a shared no-op context:
no ``record_function``, no CUDA event, no allocation, no counter read.

Each finished span becomes a :class:`Record`: its name, id, the id of its
parent (the enclosing span on the same thread, or the span passed
explicitly to a worker thread), the id of its root (shared by every span
of one call into the API), host start and end (``time.perf_counter_ns``),
the device milliseconds of a device span, ``launches``, the change
over the span in the sum of the kernel wrappers' launch counters
(:func:`launch_count`), and ``counts``, named quantities that the code
inside the span adds to it (``_Span.add``), such as the bytes that a halo
exchange writes.

Three kinds of span:

- a host span (``span(name)``) reads only the host clock;
- a host range (``span(name, ranged=True)``) also enters the profiler's
  trace as a ``record_function`` range named as the span, while the
  profiler is on in the thread, so that the trace's idle gaps can be named
  by it. Only spans that launch no kernel of the program are ranges: the
  profiler copies a range that encloses device work onto the device's
  timeline as an annotation, so a reader of the trace leaves annotations
  out of the device's work (the sharded path's ``sdf.sharded.upload`` and
  ``sdf.sharded.halo`` ranges enclose torch's copies);
- a device span (``span(name, device)``) records a pair of CUDA events on
  the current stream of a CUDA `device`. Its device time is the time the
  stream took to pass from the start marker to the end marker, so it
  includes any wait inside the span while the host enqueued more slowly
  than the card ran; its host time tells whether the stage is
  launch-bound. On a CPU device it has no device time.

Records go into a ring of the newest :data:`RING` spans. :func:`spans`
returns them, resolving the CUDA events only then, after they have
completed. An operator who wants a timeline runs ``torch.profiler``: the
host ranges appear in its trace under their ``sdf.`` names.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

from .kernels import build

__all__ = ["RING", "Record", "begin", "clear", "disable", "enable",
           "launch_count", "self_ms", "span", "spans"]

RING = 8192  # records kept, the newest

_on = False
_profiling = torch.autograd._profiler_enabled
_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


@dataclasses.dataclass(frozen=True)
class Record:
    """One finished span. `device_ms` is None for a host span and for a
    device span off a CUDA device; `counts` holds what the code inside the
    span added (``_Span.add``)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]
    launches: int
    counts: Dict[str, int] = dataclasses.field(default_factory=dict,
                                               hash=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def enable() -> None:
    """Record spans on every thread until :func:`disable`."""
    global _on
    _on = True


def disable() -> None:
    """Record spans only where a ``torch.profiler`` session is active."""
    global _on
    _on = False


def launch_count() -> int:
    """The sum of the kernel wrappers' ``.launches`` counters (those
    registered by ``kernels.build.counted``)."""
    return sum(f.launches for f in build.COUNTED)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _current():
    """The innermost open span of this thread (None when there is none)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Span:
    """An open span; :meth:`end` files its record."""

    __slots__ = ("name", "id", "parent", "root", "ranged", "start_ns",
                 "end_ns", "launches", "counts", "device_ms", "_stream",
                 "_events", "_range")

    def __init__(self, name: str, device, ranged: bool, parent):
        self.name = name
        self.id = next(_ids)
        if parent is None:
            parent = _current()
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.ranged = ranged
        self.counts = {}
        self.device_ms = None
        self._events = self._range = None
        self._stream = None
        if device is not None and device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)

    def begin(self) -> "_Span":
        self.launches = launch_count()
        if self.ranged and _profiling():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def end(self) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.launches = launch_count() - self.launches
        with _lock:
            _ring.append(self)

    def add(self, name: str, n: int) -> None:
        """Add `n` to the span's count `name`."""
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def __enter__(self) -> "_Span":
        self.begin()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self.end()
        return False

    def record(self) -> Record:
        """The record, the device time resolved once its end marker has
        passed."""
        if self._events is not None:
            start, stop = self._events
            stop.synchronize()
            self.device_ms = start.elapsed_time(stop)
            self._events = self._stream = None
        return Record(self.name, self.id, self.parent, self.root,
                      self.start_ns, self.end_ns, self.device_ms,
                      self.launches, dict(self.counts))


class _Off:
    """The span handed out while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, device=None, *, ranged: bool = False, parent=None):
    """A span as a context manager. `device` (a torch.device) makes it a
    device span; `ranged` a host range in the profiler's trace; `parent`
    (an open span, handed to a worker thread) records it under that span,
    and records it whenever that span is recorded."""
    if parent is None and not _on and not _profiling():
        return _OFF
    return _Span(name, device, ranged, parent)


def begin(name: str, parent=None, device=None):
    """Open a span that ends later, maybe on another call, by its
    ``end()``; it is not the enclosing span of what runs meanwhile. A host
    span, or with `device` a device span on that device's current stream.
    None while tracing is off."""
    if parent is None and not _on and not _profiling():
        return None
    return _Span(name, device, False, parent).begin()


def spans() -> List[Record]:
    """The finished records in the ring, oldest first (waits for the
    device to pass the end markers of the device spans among them)."""
    with _lock:
        live = list(_ring)
    return [s.record() for s in live]


def clear() -> None:
    """Empty the ring."""
    with _lock:
        _ring.clear()


def self_ms(record: Record, records, device: bool = False):
    """`record`'s time less its children's among `records`: host
    milliseconds less the union of its children's host intervals inside
    it, or (`device`) its device milliseconds less the sum of its
    children's. None for a device span without device time."""
    children = [r for r in records if r.parent == record.id]
    if device:
        if record.device_ms is None:
            return None
        return record.device_ms - sum(r.device_ms for r in children
                                      if r.device_ms is not None)
    covered, hi = 0, record.start_ns
    for a, b in sorted((max(r.start_ns, record.start_ns),
                        min(r.end_ns, record.end_ns)) for r in children):
        a = max(a, hi)
        if b > a:
            covered += b - a
            hi = b
    return (record.end_ns - record.start_ns - covered) / 1e6
