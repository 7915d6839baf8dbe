"""What the per-layer metric readers share."""

from __future__ import annotations


def span_median(record: dict, name: str, device: bool = False):
    """The median ms of span `name` over the traced run's calls (None
    without spans; a device span only from a card)."""
    spans = record.get("spans")
    if spans is None or (device and record.get("platform") != "gpu"):
        return None
    return spans.median(name)


def idle_percent(record: dict):
    """The share of the profiled slice in which no kernel or copy ran on
    the device, in percent."""
    prof = record.get("profile")
    if not prof or prof["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_us"] / prof["window_us"])


def kernel_us_per_call(record: dict, pattern: str):
    """Device microseconds a profiled call of the kernels whose name holds
    `pattern` (None where the slice ran none)."""
    prof = record.get("profile")
    if not prof or not prof["calls"]:
        return None
    us = sum(t for name, t in prof["kernels"].items() if pattern in name)
    return us / prof["calls"] if us > 0 else None
