"""The upstream's mode-2a grid sizing (``app/main.cpp:116-151``): Nx given,
dx = size_x / (Nx - 2 pad), Ny and Nz proportional with round-half-up, the
grid centred on the mesh's bounding box. Frozen copy of
``sdfgenfast_tpu_torch.grid.sizing_mode2a_proportional``."""

from __future__ import annotations

import numpy as np


def mode2a(min_box, max_box, target_nx: int, padding: int = 1):
    """(origin 3-tuple of float, dx float, (nx, ny, nz))."""
    if target_nx <= 0:
        raise ValueError("Grid dimension must be a positive integer")
    padding = max(int(padding), 1)
    min_box = np.asarray(min_box, dtype=np.float32)
    max_box = np.asarray(max_box, dtype=np.float32)
    size = max_box - min_box
    dx = np.float32(size[0]) / np.float32(target_nx - 2 * padding)
    ny = int(np.float32(size[1]) / dx + np.float32(0.5)) + 2 * padding
    nz = int(np.float32(size[2]) / dx + np.float32(0.5)) + 2 * padding
    shape = (int(target_nx), ny, nz)
    grid_size = np.asarray(shape, dtype=np.float32) * np.float32(dx)
    center = (min_box + max_box) * np.float32(0.5)
    origin = center - grid_size * np.float32(0.5)
    return tuple(float(v) for v in origin), float(dx), shape
