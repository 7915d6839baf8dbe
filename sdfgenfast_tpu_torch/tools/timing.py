"""What the measurement tools share: the device a tool runs on, the card's
name and power limit, and stage timers.

A tool runs on the current CUDA device unless it is given ``--device cpu``;
without a card it raises, naming CUDA (``platform.resolve_device``). On the
card every stage is timed by CUDA events around its own launches; on the
CPU (a rehearsal of the tool, the kernels' plain twins) by the host clock,
and the tools write no device metric for a CPU run.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Optional

import torch

from ..platform import resolve_device

__all__ = ["tool_device", "card_line", "sync", "Stages"]


def tool_device(name: Optional[str]) -> torch.device:
    """The device a tool runs on: the current CUDA device for None (raising,
    naming CUDA, without one), the CPU for "cpu", else that CUDA device."""
    if name is None:
        return resolve_device("auto")
    if torch.device(name).type == "cpu":
        return resolve_device("cpu")
    return resolve_device("gpu", name)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them ("cpu" for the CPU,
    "<name>, power limit not measured" without nvidia-smi)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        r = None
    if r is None or r.returncode != 0 or not r.stdout.strip():
        return (f"{torch.cuda.get_device_name(index)}, power limit not "
                f"measured")
    return r.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """Times named stages on `device` and keeps each stage's median in
    ``ms`` (summed over the calls of a stage name made more than once).

    :meth:`run` calls ``fn()`` once to warm up, then `repeats` times, each
    timed alone: CUDA events around the call on the card (its launches on
    the current stream, after a synchronize), the host clock on the CPU.
    It returns the last call's output. :meth:`host` times host work by the
    host clock (the minimum of `repeats` calls, none to warm up)."""

    def __init__(self, device: torch.device, repeats: int = 3):
        self.device = device
        self.repeats = repeats
        self.ms: dict = {}
        self.calls: dict = {}

    def _add(self, name: str, ms: float) -> None:
        self.ms[name] = self.ms.get(name, 0.0) + ms
        self.calls[name] = self.calls.get(name, 0) + 1

    def run(self, name: str, fn):
        out = fn()
        times = []
        for _ in range(self.repeats):
            sync(self.device)
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                out = fn()
                times.append((time.perf_counter() - t0) * 1e3)
        self._add(name, statistics.median(times))
        return out

    def host(self, name: str, fn):
        out, best = None, float("inf")
        for _ in range(self.repeats):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        self._add(name, best)
        return out
