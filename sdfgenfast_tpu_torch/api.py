"""Public API, mirroring the reference's Python surface.

Counterpart of ``sdfgenfast_tpu/api.py`` with the same signatures,
validation and error types, plus a ``device`` argument. ``backend`` is
``"auto" | "cpu" | "gpu"``: ``"auto"`` and ``"gpu"`` run on CUDA and raise
when there is none (unlike the JAX package's ``"auto"``, which falls back to
its CPU backend); only an explicit ``"cpu"`` runs the kernels' plain-torch
twins on the CPU.

``generate_sdf_batch`` runs many meshes on one grid, binning mesh k+1 on the
host while mesh k's kernels run on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .grid import GridSpec, sizing_python_api
from .io import mesh_io as _mesh_io
from .io import sdf_io as _sdf_io
from .mesh import Mesh
from .pipeline import SDFConfig, bin_mesh, make_level_set3
from .platform import is_cuda_available, resolve_device

__all__ = [
    "generate_sdf_batch",
    "load_mesh",
    "generate_sdf",
    "save_sdf",
    "load_sdf",
    "is_gpu_available",
    "generate_from_mesh",
    "generate_from_file",
]

Device = Optional[Union[str, torch.device]]


def is_gpu_available() -> bool:
    """Runtime accelerator probe (common/sdfgen_unified.cpp:19-28)."""
    return is_cuda_available()


def load_mesh(filename: str) -> Tuple[np.ndarray, np.ndarray, tuple]:
    """Returns (vertices (N,3) f32, triangles (M,3) u32, bounds tuple) like
    sdfgen_py.cpp:101-157."""
    mesh, mn, mx = _mesh_io.load_mesh(str(filename))
    bounds = (tuple(float(v) for v in mn), tuple(float(v) for v in mx))
    return mesh.verts, mesh.tris, bounds


def _validate_mesh_arrays(vertices, triangles):
    """Shape/dtype validation with the reference's conversion semantics:
    compatible numeric dtypes are AUTO-CONVERTED to float32/uint32 and
    non-contiguous inputs are copied; wrong shapes/kinds raise."""
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise TypeError(f"vertices must have shape (N, 3), got {vertices.shape}")
    if triangles.ndim != 2 or triangles.shape[1] != 3:
        raise TypeError(f"triangles must have shape (M, 3), got {triangles.shape}")
    if not np.issubdtype(vertices.dtype, np.floating) and not np.issubdtype(
        vertices.dtype, np.integer
    ):
        raise TypeError(f"vertices dtype must be numeric, got {vertices.dtype}")
    if not np.issubdtype(triangles.dtype, np.integer):
        raise TypeError(f"triangles dtype must be an integer type, got {triangles.dtype}")
    if np.issubdtype(triangles.dtype, np.signedinteger) and triangles.size:
        if int(triangles.min()) < 0:
            raise ValueError("triangle indices must be non-negative")
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    triangles = np.ascontiguousarray(triangles, dtype=np.uint32)
    return vertices, triangles


def generate_sdf(
    vertices: np.ndarray,
    triangles: np.ndarray,
    origin,
    dx: float,
    nx: int,
    ny: int,
    nz: int,
    exact_band: int = 1,
    backend: str = "auto",
    num_threads: int = 0,
    far_field: str = "exact",
    device: Device = None,
) -> np.ndarray:
    """Generate an (nx, ny, nz) float32 SDF (NumPy). Signature and validation
    follow sdfgen_py.cpp:160-218; `num_threads` is accepted for compatibility
    and ignored. `device` picks the CUDA device (or "cpu" with
    backend="cpu"); by default the current CUDA device."""
    vertices, triangles = _validate_mesh_arrays(vertices, triangles)
    if vertices.shape[0] == 0 or triangles.shape[0] == 0:
        raise ValueError(
            "Cannot generate SDF from empty mesh (vertices or triangles are empty)"
        )
    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError("Grid dimensions must be positive (nx, ny, nz > 0)")
    if not (float(dx) > 0.0):
        raise ValueError("Cell spacing dx must be positive")
    del num_threads
    dev = resolve_device(backend, device)

    grid = GridSpec(tuple(float(v) for v in origin), float(dx),
                    (int(nx), int(ny), int(nz)))
    mesh = Mesh(vertices, triangles)
    config = SDFConfig(exact_band=exact_band, far_field=far_field)
    phi = make_level_set3(mesh, grid, config, device=dev)
    return phi.cpu().numpy()


def generate_sdf_batch(
    meshes,
    origin,
    dx: float,
    nx: int,
    ny: int,
    nz: int,
    exact_band: int = 1,
    backend: str = "auto",
    far_field: str = "exact",
    device: Device = None,
    device_mesh=None,
):
    """Generate SDFs for a batch of meshes on one shared grid.

    `meshes` is a sequence of (vertices, triangles) pairs, each validated as
    :func:`generate_sdf` validates its arrays. Returns a list of
    (nx, ny, nz) float32 NumPy arrays, one per mesh, each equal to the
    single call's result.

    One-deep pipeline, as ``sdfgenfast_tpu.api.generate_sdf_batch``: mesh
    k+1 is binned on the host while mesh k's kernels run (the device work
    is launched without a host sync), then mesh k is copied back.
    `device_mesh` (multi-GPU sharding) is not ported and raises
    NotImplementedError.
    """
    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError("Grid dimensions must be positive (nx, ny, nz > 0)")
    if not (float(dx) > 0.0):
        raise ValueError("Cell spacing dx must be positive")
    if device_mesh is not None:
        raise NotImplementedError(
            "device_mesh (sharding over several GPUs) is not ported yet")
    dev = resolve_device(backend, device)
    grid = GridSpec(tuple(float(v) for v in origin), float(dx),
                    (int(nx), int(ny), int(nz)))
    config = SDFConfig(exact_band=exact_band, far_field=far_field)

    validated = []
    for vertices, triangles in meshes:
        v, t = _validate_mesh_arrays(vertices, triangles)
        if v.shape[0] == 0 or t.shape[0] == 0:
            raise ValueError(
                "Cannot generate SDF from empty mesh "
                "(vertices or triangles are empty)")
        validated.append(Mesh(v, t))

    out = []
    pending = None  # device result of the previous mesh, maybe still running
    for mesh in validated:
        binned = bin_mesh(mesh, grid, config)
        if pending is not None:
            out.append(pending.cpu().numpy())
        pending = make_level_set3(mesh, grid, config, binned, device=dev)
    if pending is not None:
        out.append(pending.cpu().numpy())
    return out


def save_sdf(filename: str, sdf_array: np.ndarray, origin, dx: float) -> None:
    sdf_array = np.asarray(sdf_array)
    if sdf_array.ndim != 3:
        raise ValueError("SDF array must be 3-dimensional")
    if 0 in sdf_array.shape:
        raise ValueError("SDF array dimensions cannot be zero")
    _sdf_io.write_sdf(str(filename), sdf_array, origin, float(dx))


def load_sdf(filename: str):
    """Returns (sdf, origin, dx, bounds); dx derived from the x extent only,
    like sdfgen_py.cpp:300."""
    phi, mn, mx = _sdf_io.read_sdf(str(filename))
    dx = float((mx[0] - mn[0]) / phi.shape[0])
    origin = (float(mn[0]), float(mn[1]), float(mn[2]))
    bounds = (origin, (float(mx[0]), float(mx[1]), float(mx[2])))
    return phi, origin, dx, bounds


def generate_from_mesh(
    vertices: np.ndarray,
    triangles: np.ndarray,
    nx: int,
    ny: Optional[int] = None,
    nz: Optional[int] = None,
    dx: Optional[float] = None,
    padding: int = 1,
    exact_band: int = 1,
    backend: str = "auto",
    num_threads: int = 0,
    far_field: str = "exact",
    device: Device = None,
) -> Tuple[np.ndarray, dict]:
    """Auto grid sizing from array bounds — python/sdfgen.py:47-142 semantics."""
    vertices = np.asarray(vertices)
    min_box = vertices.min(axis=0)
    max_box = vertices.max(axis=0)
    extents = max_box - min_box
    if ny is None or nz is None:
        if dx is None:
            dx = float(extents[0]) / nx
        ny = int(np.ceil(extents[1] / dx)) if ny is None else ny
        nz = int(np.ceil(extents[2] / dx)) if nz is None else nz
    else:
        if dx is None:
            dx = float(max(extents[0] / nx, extents[1] / ny, extents[2] / nz))
    nx += 2 * padding
    ny += 2 * padding
    nz += 2 * padding
    origin = min_box - padding * np.float32(dx)
    sdf = generate_sdf(
        vertices, triangles, tuple(origin), dx, nx, ny, nz,
        exact_band=exact_band, backend=backend, num_threads=num_threads,
        far_field=far_field, device=device,
    )
    metadata = {
        "origin": tuple(float(v) for v in origin),
        "dx": dx,
        "bounds": (tuple(float(v) for v in min_box), tuple(float(v) for v in max_box)),
        "backend": backend,
    }
    return sdf, metadata


def generate_from_file(
    filename: str,
    nx: Optional[int] = None,
    ny: Optional[int] = None,
    nz: Optional[int] = None,
    dx: Optional[float] = None,
    padding: int = 1,
    exact_band: int = 1,
    backend: str = "auto",
    num_threads: int = 0,
    far_field: str = "exact",
    device: Device = None,
) -> Tuple[np.ndarray, dict]:
    """Load + size + generate — python/sdfgen.py:145-265 semantics."""
    vertices, triangles, bounds = load_mesh(filename)
    min_box = np.array(bounds[0], dtype=np.float32)
    max_box = np.array(bounds[1], dtype=np.float32)
    spec = sizing_python_api(min_box, max_box, nx, ny, nz, dx, padding)
    sdf = generate_sdf(
        vertices, triangles, spec.origin, spec.dx, *spec.shape,
        exact_band=exact_band, backend=backend, num_threads=num_threads,
        far_field=far_field, device=device,
    )
    metadata = {
        "origin": spec.origin,
        "dx": spec.dx,
        "bounds": (tuple(float(v) for v in min_box), tuple(float(v) for v in max_box)),
        "backend": backend,
    }
    return sdf, metadata
