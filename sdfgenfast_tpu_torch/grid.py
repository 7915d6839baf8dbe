"""Grid specification and grid-sizing logic.

Copy of ``sdfgenfast_tpu/grid.py`` (framework-free). The reference's grid
handling:

- ``GridSpec`` plays the role the (origin, dx, ni, nj, nk) argument bundle plays
  throughout the reference (e.g. ``cpu_lib/makelevelset3.h:39-41``).
- The three CLI sizing modes reproduce the math of ``app/main.cpp``:
  Mode 1  (dx-specified, legacy OBJ)       -> app/main.cpp:246-252
  Mode 2a (proportional from Nx, STL)      -> app/main.cpp:116-151, 234-245
  Mode 2b (manual Nx,Ny,Nz, STL)           -> app/main.cpp:153-191, 234-245
- The Python high-level sizing modes reproduce ``python/sdfgen.py:210-241``.

Everything here is host-side NumPy: grid sizing is metadata computation, not
device work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A regular 3D sampling grid: ``x(i,j,k) = origin + (i,j,k) * dx``.

    Cell (i, j, k) samples the *point* ``origin + (i,j,k)*dx`` exactly as the
    reference does (``cpu_lib/makelevelset3.cpp:214``). ``bounds_max`` follows
    the .sdf header convention ``min + n*dx`` (``common/sdf_io.cpp:39-41``).
    """

    origin: Tuple[float, float, float]
    dx: float
    shape: Tuple[int, int, int]  # (ni, nj, nk)

    def __post_init__(self):
        ni, nj, nk = self.shape
        if ni <= 0 or nj <= 0 or nk <= 0:
            raise ValueError("Grid dimensions must be positive (nx, ny, nz > 0)")
        if not (self.dx > 0.0):
            raise ValueError("Cell spacing dx must be positive")

    @property
    def ni(self) -> int:
        return self.shape[0]

    @property
    def nj(self) -> int:
        return self.shape[1]

    @property
    def nk(self) -> int:
        return self.shape[2]

    @property
    def num_cells(self) -> int:
        ni, nj, nk = self.shape
        return ni * nj * nk

    @property
    def bounds_min(self) -> np.ndarray:
        return np.asarray(self.origin, dtype=np.float32)

    @property
    def bounds_max(self) -> np.ndarray:
        # min + n*dx, matching the on-disk header math (common/sdf_io.cpp:39-41).
        return (
            np.asarray(self.origin, dtype=np.float32)
            + np.asarray(self.shape, dtype=np.float32) * np.float32(self.dx)
        )

    def cell_positions_axis(self, axis: int, dtype=np.float64) -> np.ndarray:
        """World coordinates of cell centers along one axis."""
        n = self.shape[axis]
        return np.asarray(self.origin[axis], dtype) + np.arange(n, dtype=dtype) * np.asarray(
            self.dx, dtype
        )


# ---------------------------------------------------------------------------
# Grid sizing modes (reference CLI semantics)
# ---------------------------------------------------------------------------


def sizing_mode1_legacy(
    min_box: np.ndarray, max_box: np.ndarray, dx: float, padding: int
) -> GridSpec:
    """Mode 1 (legacy OBJ): pad the bbox by ``padding*dx`` per side, then derive
    sizes by truncation, reproducing ``app/main.cpp:246-252``:

        min -= padding*dx; max += padding*dx; sizes = Vec3ui((max-min)/dx)
    """
    if padding < 1:
        padding = 1
    dx = float(np.float32(dx))
    min_box = np.asarray(min_box, dtype=np.float32).copy()
    max_box = np.asarray(max_box, dtype=np.float32).copy()
    pad = np.float32(padding) * np.float32(dx)
    min_box = min_box - pad
    max_box = max_box + pad
    # Vec3ui((max-min)/dx): float32 division then C truncation toward zero.
    sizes = ((max_box - min_box) / np.float32(dx)).astype(np.uint32)
    return GridSpec(tuple(float(v) for v in min_box), dx, tuple(int(s) for s in sizes))


def _recenter_bounds(
    min_box: np.ndarray, max_box: np.ndarray, sizes: Tuple[int, int, int], dx: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Mode 2 recentering: center the mesh inside the exact target grid
    (``app/main.cpp:240-245``)."""
    min_box = np.asarray(min_box, dtype=np.float32)
    max_box = np.asarray(max_box, dtype=np.float32)
    grid_size = np.asarray(sizes, dtype=np.float32) * np.float32(dx)
    center = (min_box + max_box) * np.float32(0.5)
    new_min = center - grid_size * np.float32(0.5)
    new_max = center + grid_size * np.float32(0.5)
    return new_min, new_max


def sizing_mode2a_proportional(
    min_box: np.ndarray, max_box: np.ndarray, target_nx: int, padding: int = 1
) -> GridSpec:
    """Mode 2a: Nx given; dx = size_x/(Nx-2*pad); Ny/Nz proportional with
    round-half-up; bounds recentered. Reproduces ``app/main.cpp:116-151``."""
    if target_nx <= 0:
        raise ValueError("Grid dimension must be a positive integer")
    if padding < 1:
        padding = 1
    min_box = np.asarray(min_box, dtype=np.float32)
    max_box = np.asarray(max_box, dtype=np.float32)
    mesh_size = max_box - min_box
    dx = np.float32(mesh_size[0]) / np.float32(target_nx - 2 * padding)
    ny = int(np.float32(mesh_size[1]) / dx + np.float32(0.5)) + 2 * padding
    nz = int(np.float32(mesh_size[2]) / dx + np.float32(0.5)) + 2 * padding
    sizes = (int(target_nx), ny, nz)
    new_min, _ = _recenter_bounds(min_box, max_box, sizes, float(dx))
    return GridSpec(tuple(float(v) for v in new_min), float(dx), sizes)


def sizing_mode2b_manual(
    min_box: np.ndarray,
    max_box: np.ndarray,
    target_nx: int,
    target_ny: int,
    target_nz: int,
    padding: int = 1,
) -> GridSpec:
    """Mode 2b: exact Nx,Ny,Nz; dx = max of per-axis fits; bounds recentered.
    Reproduces ``app/main.cpp:180-190, 234-245``."""
    if target_nx <= 0 or target_ny <= 0 or target_nz <= 0:
        raise ValueError("Grid dimensions must be positive integers")
    if padding < 1:
        padding = 1
    min_box = np.asarray(min_box, dtype=np.float32)
    max_box = np.asarray(max_box, dtype=np.float32)
    mesh_size = max_box - min_box
    dx_x = np.float32(mesh_size[0]) / np.float32(target_nx - 2 * padding)
    dx_y = np.float32(mesh_size[1]) / np.float32(target_ny - 2 * padding)
    dx_z = np.float32(mesh_size[2]) / np.float32(target_nz - 2 * padding)
    dx = float(max(dx_x, dx_y, dx_z))
    sizes = (int(target_nx), int(target_ny), int(target_nz))
    new_min, _ = _recenter_bounds(min_box, max_box, sizes, dx)
    return GridSpec(tuple(float(v) for v in new_min), dx, sizes)


def sizing_python_api(
    min_box: np.ndarray,
    max_box: np.ndarray,
    nx: Optional[int] = None,
    ny: Optional[int] = None,
    nz: Optional[int] = None,
    dx: Optional[float] = None,
    padding: int = 1,
) -> GridSpec:
    """The high-level Python API sizing of ``python/sdfgen.py:210-241``:

    - dx given: per-axis sizes ceil(extent/dx) for any of nx/ny/nz not given;
    - nx given (ny/nz optional): dx = extent_x/nx, missing dims ceil-prop;
    - nx,ny,nz given, no dx: dx = max(extent/n) over axes;
    then ``n += 2*padding`` per axis and ``origin = min_box - padding*dx``.
    """
    min_box = np.asarray(min_box, dtype=np.float32)
    max_box = np.asarray(max_box, dtype=np.float32)
    extents = max_box - min_box
    # validate up front: the reference defers to generate_sdf's dimension
    # check (python/sdfgen.py:210-241 divides by nx unguarded, relying on
    # numpy inf propagation); a plain-int nx=0 here would be a raw
    # ZeroDivisionError instead of the API's ValueError contract
    for name, v in (("nx", nx), ("ny", ny), ("nz", nz)):
        if v is not None and v <= 0:
            raise ValueError(f"Grid dimension {name} must be positive, got {v}")
    if dx is not None and dx <= 0:
        raise ValueError(f"dx must be positive, got {dx}")
    if dx is not None:
        if nx is None:
            nx = int(math.ceil(extents[0] / dx))
        if ny is None:
            ny = int(math.ceil(extents[1] / dx))
        if nz is None:
            nz = int(math.ceil(extents[2] / dx))
    elif nx is not None:
        if ny is None or nz is None:
            dx = float(extents[0]) / nx
            ny = int(math.ceil(extents[1] / dx)) if ny is None else ny
            nz = int(math.ceil(extents[2] / dx)) if nz is None else nz
        else:
            dx = float(max(extents[0] / nx, extents[1] / ny, extents[2] / nz))
    else:
        raise ValueError(
            "Must specify either 'dx' or 'nx' (or 'nx', 'ny', 'nz') for grid sizing"
        )
    nx += 2 * padding
    ny += 2 * padding
    nz += 2 * padding
    origin = min_box - np.float32(padding) * np.float32(dx)
    return GridSpec(tuple(float(v) for v in origin), float(dx), (nx, ny, nz))
