"""What the measurement tools share: the device a tool runs on, the card's
name and power limit, and the device's synchronize.

A tool runs on the current CUDA device unless it is given ``--device cpu``;
without a card it raises, naming CUDA (``platform.resolve_device``). On the
CPU (a rehearsal of the tool, the kernels' plain twins) the tools write no
device metric.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

from ..platform import resolve_device

__all__ = ["tool_device", "card_line", "sync"]


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
