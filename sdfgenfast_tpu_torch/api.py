"""Public API, mirroring the reference's Python surface.

Counterpart of ``sdfgenfast_tpu/api.py`` with the same signatures,
validation and error types, plus a ``device`` argument. ``backend`` is
``"auto" | "cpu" | "gpu"``: ``"auto"`` and ``"gpu"`` run on CUDA and raise
when there is none (unlike the JAX package's ``"auto"``, which falls back to
its CPU backend); only an explicit ``"cpu"`` runs the kernels' plain-torch
twins on the CPU.

``far_field`` takes every mode of the JAX package (``"exact"``, the
default, ``"propagate"``, ``"eikonal"``). The generators also take an
optional ``config`` (``pipeline.SDFConfig``) for the schedule knobs (the
capped or flat jump-flood ladder, ``tile_shape``, ``chamfer_passes``, ...);
``exact_band`` and ``far_field`` always come from their own arguments.

Every result comes back through ``upload.to_host`` (pinned staging on a
side stream). ``generate_sdf_batch`` runs many meshes on one grid, binning
and uploading mesh k+1 while mesh k's kernels run on the card and its grid
is copied back (``upload.to_host_async``); with a ``device_mesh``
(``parallel.make_device_mesh``, or ``parallel.multihost.global_device_mesh``
in every process of a process group) each mesh's grid is sharded over its
devices (``parallel/sharded.py``, ``parallel/multihost.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .grid import GridSpec, sizing_python_api
from .io import mesh_io as _mesh_io
from .io import sdf_io as _sdf_io
from .mesh import Mesh
from .parallel.multihost import (assemble_blocks, fetch_global,
                                 sharded_sdf_multihost)
from .parallel.sharded import (bin_mesh_sharded, check_device_mesh,
                               sharded_sdf, spans_processes)
from .pipeline import SDFConfig, bin_mesh, make_level_set3
from .platform import is_cuda_available, resolve_device
from .upload import to_host, to_host_async

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


def _config(config: Optional[SDFConfig], exact_band: int,
            far_field: str) -> SDFConfig:
    return dataclasses.replace(config if config is not None else SDFConfig(),
                               exact_band=exact_band, far_field=far_field)


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
    config: Optional[SDFConfig] = None,
) -> np.ndarray:
    """Generate an (nx, ny, nz) float32 SDF (NumPy). Signature and validation
    follow sdfgen_py.cpp:160-218; `num_threads` is accepted for compatibility
    and ignored. `device` picks the CUDA device (or "cpu" with
    backend="cpu"); by default the current CUDA device. `config` sets the
    pipeline's other knobs (exact_band and far_field come from their
    arguments)."""
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
    phi = make_level_set3(mesh, grid, _config(config, exact_band, far_field),
                          device=dev)
    return to_host(phi)


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
    config: Optional[SDFConfig] = None,
):
    """Generate SDFs for a batch of meshes on one shared grid.

    `meshes` is a sequence of (vertices, triangles) pairs, each validated as
    :func:`generate_sdf` validates its arrays. Returns a list of
    (nx, ny, nz) float32 NumPy arrays, one per mesh, each equal to the
    single call's result.

    One-deep pipeline, as ``sdfgenfast_tpu.api.generate_sdf_batch``: mesh
    k's copy to the host starts as soon as its work is launched
    (``upload.to_host_async``, the counterpart of ``copy_to_host_async``),
    and mesh k+1 is binned and uploaded (one blob, ``bin_mesh(...,
    device=...)``) while mesh k's kernels and copy run; mesh k+1's kernels
    are queued before mesh k's copy is waited for. With
    ``far_field="propagate"`` the plane scans end every pass in a host sync,
    so mesh k's device work is done before mesh k+1 is binned: only the
    copy overlaps.

    `device_mesh` (a ``parallel.DeviceMesh``) shards every grid over its
    devices (``parallel.sharded_sdf``), with the same one-deep overlap:
    mesh k+1 is binned while mesh k's shards run. Its devices take the
    place of `device`: CUDA devices for ``"auto"`` and ``"gpu"``, CPU
    devices for ``"cpu"``. A mesh from ``multihost.global_device_mesh``
    spreads the shards over the processes of a process group: every process
    calls with the same arguments, runs its own shards
    (``multihost.sharded_sdf_multihost``) and returns the same grids
    (``multihost.fetch_global``).
    """
    if nx <= 0 or ny <= 0 or nz <= 0:
        raise ValueError("Grid dimensions must be positive (nx, ny, nz > 0)")
    if not (float(dx) > 0.0):
        raise ValueError("Cell spacing dx must be positive")
    if device_mesh is None:
        dev = resolve_device(backend, device)
    else:
        check_device_mesh(device_mesh)
        _check_mesh_devices(backend, device, device_mesh)
    grid = GridSpec(tuple(float(v) for v in origin), float(dx),
                    (int(nx), int(ny), int(nz)))
    config = _config(config, exact_band, far_field)

    validated = []
    for vertices, triangles in meshes:
        v, t = _validate_mesh_arrays(vertices, triangles)
        if v.shape[0] == 0 or t.shape[0] == 0:
            raise ValueError(
                "Cannot generate SDF from empty mesh "
                "(vertices or triangles are empty)")
        validated.append(Mesh(v, t))

    if device_mesh is not None:
        return _sharded_batch(validated, grid, config, device_mesh)
    out = []
    pending = None  # the previous mesh's copy to the host, maybe running
    for mesh in validated:
        binned = bin_mesh(mesh, grid, config, device=dev)
        copy = to_host_async(make_level_set3(mesh, grid, config, binned,
                                             device=dev))
        if pending is not None:
            out.append(pending.result())
        pending = copy
    if pending is not None:
        out.append(pending.result())
    return out


def _check_mesh_devices(backend: str, device: Device, device_mesh) -> None:
    """A device mesh names its devices: `device` must be None, and the
    devices must be CPU ones for backend "cpu", CUDA ones otherwise."""
    devices = device_mesh.devices.flat
    kinds = {d.type for d in devices}
    if device is not None:
        raise ValueError("give device or device_mesh, not both")
    resolve_device(backend, "cpu" if backend == "cpu" else None)
    want = "cpu" if backend == "cpu" else "cuda"
    if kinds != {want}:
        raise ValueError(f"backend={backend!r} needs {want} devices in the "
                         f"device mesh, got {sorted(kinds)}")


def _sharded_batch(validated, grid: GridSpec, config: SDFConfig,
                   device_mesh):
    """The batch over a device mesh (``sdfgenfast_tpu.api._sharded_batch``):
    each mesh's host binning overlaps the previous mesh's shards on the
    devices. In one process each block's copy to the host starts when the
    shards are launched and writes into its slice of one (ni, nj, nk)
    array; across processes every process bins every mesh, runs its shards
    and gathers every block."""
    dims = tuple(device_mesh.devices.shape)
    multi = spans_processes(device_mesh)

    def launch(mesh):
        sb = bin_mesh_sharded(mesh, grid, dims, config)
        if multi:
            return sharded_sdf_multihost(sb, device_mesh, mesh.verts)
        blocks = sharded_sdf(sb, device_mesh, verts=mesh.verts,
                             assemble=False)
        out = np.empty(grid.shape, np.float32)
        nj, nk = blocks[0][0].shape[1:]
        return out, [to_host_async(b, out=out[:, a * nj:(a + 1) * nj,
                                              c * nk:(c + 1) * nk])
                     for a, row in enumerate(blocks)
                     for c, b in enumerate(row)]

    def collect(launched):
        if multi:
            return assemble_blocks(fetch_global(launched, device_mesh))
        out, copies = launched
        for copy in copies:
            copy.result()
        return out

    out = []
    pending = None
    for mesh in validated:
        launched = launch(mesh)  # bin mesh k+1 while mesh k computes
        if pending is not None:
            out.append(collect(pending))
        pending = launched
    if pending is not None:
        out.append(collect(pending))
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
    config: Optional[SDFConfig] = None,
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
        far_field=far_field, device=device, config=config,
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
    config: Optional[SDFConfig] = None,
) -> Tuple[np.ndarray, dict]:
    """Load + size + generate — python/sdfgen.py:145-265 semantics."""
    vertices, triangles, bounds = load_mesh(filename)
    min_box = np.array(bounds[0], dtype=np.float32)
    max_box = np.array(bounds[1], dtype=np.float32)
    spec = sizing_python_api(min_box, max_box, nx, ny, nz, dx, padding)
    sdf = generate_sdf(
        vertices, triangles, spec.origin, spec.dx, *spec.shape,
        exact_band=exact_band, backend=backend, num_threads=num_threads,
        far_field=far_field, device=device, config=config,
    )
    metadata = {
        "origin": spec.origin,
        "dx": spec.dx,
        "bounds": (tuple(float(v) for v in min_box), tuple(float(v) for v in max_box)),
        "backend": backend,
    }
    return sdf, metadata
