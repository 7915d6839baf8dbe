"""Device resolution for the PyTorch port.

Counterpart of ``sdfgenfast_tpu/platform.py``. Nothing here picks a device
implicitly: callers pass a ``torch.device``, and :func:`resolve_device` turns
the reference's ``backend`` vocabulary into one. ``"auto"`` and ``"gpu"``
mean CUDA and raise when there is none; only an explicit ``"cpu"`` runs the
plain PyTorch twins of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["is_cuda_available", "require_cuda", "resolve_device"]

BACKENDS = ("auto", "cpu", "gpu")


def is_cuda_available() -> bool:
    return torch.cuda.is_available()


def require_cuda() -> None:
    """Raise unless a CUDA device is visible to PyTorch."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA backend requested but no CUDA device is "
                           "available (torch.cuda.is_available() is False)")


def resolve_device(backend: str = "auto",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``backend`` in ("auto", "cpu", "gpu") plus an optional explicit device
    -> the torch.device the pipeline runs on."""
    if backend not in BACKENDS:
        raise ValueError(
            f"Invalid backend: {backend} (must be 'auto', 'cpu', or 'gpu')")
    if backend == "cpu":
        dev = torch.device("cpu") if device is None else torch.device(device)
        if dev.type != "cpu":
            raise ValueError(f"backend='cpu' conflicts with device={dev}")
        return dev
    require_cuda()
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"backend={backend!r} needs a CUDA device, got {dev}")
    return dev
