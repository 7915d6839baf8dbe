"""Binary .sdf file I/O, bit-compatible with the reference format.
Copy of ``sdfgenfast_tpu/io/sdf_io.py``.

Layout (``common/sdf_io.cpp:10-147``):
  36-byte header: 3 x int32 (ni, nj, nk) + 3 x float32 bounds_min
                  + 3 x float32 bounds_max (bounds_max = min + n*dx)
  data:           ni*nj*nk float32 written loop-order for(i)for(j)for(k),
                  i.e. k-fastest == C-order for an (ni, nj, nk) array.
Little-endian, matching the reference's raw struct writes on x86.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["write_sdf", "read_sdf", "HEADER_BYTES"]

HEADER_BYTES = 36

_HEADER_DTYPE = np.dtype(
    [("dims", "<i4", (3,)), ("bounds_min", "<f4", (3,)), ("bounds_max", "<f4", (3,))]
)


class SDFIOError(RuntimeError):
    pass


def write_sdf(filename: str, phi: np.ndarray, origin, dx: float) -> int:
    """Write an (ni, nj, nk) float32 grid. Returns the inside-cell count the
    reference reports (``common/sdf_io.cpp:48-54``)."""
    phi = np.asarray(phi)
    if phi.ndim != 3:
        raise ValueError("SDF array must be 3-dimensional")
    if 0 in phi.shape:
        raise ValueError("SDF array dimensions cannot be zero")
    phi32 = np.ascontiguousarray(phi, dtype="<f4")
    origin = np.asarray(origin, dtype=np.float32)
    header = np.zeros((), dtype=_HEADER_DTYPE)
    header["dims"] = np.asarray(phi.shape, dtype=np.int32)
    header["bounds_min"] = origin
    header["bounds_max"] = origin + np.asarray(phi.shape, np.float32) * np.float32(dx)
    with open(filename, "wb") as fh:
        fh.write(header.tobytes())
        fh.write(phi32.tobytes())
    return int((phi32 < 0.0).sum())


def read_sdf(filename: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a .sdf file. Returns (phi (ni,nj,nk) float32, bounds_min, bounds_max).

    Validates dims > 0 like ``common/sdf_io.cpp:94-99`` and that the payload is
    complete.
    """
    with open(filename, "rb") as fh:
        raw = fh.read()
    if len(raw) < HEADER_BYTES:
        raise SDFIOError(f"SDF file too short for header: {filename}")
    header = np.frombuffer(raw, dtype=_HEADER_DTYPE, count=1)[0]
    ni, nj, nk = (int(v) for v in header["dims"])
    if ni <= 0 or nj <= 0 or nk <= 0:
        raise SDFIOError(f"Invalid dimensions in SDF file: {ni}x{nj}x{nk}")
    count = ni * nj * nk
    if len(raw) < HEADER_BYTES + 4 * count:
        raise SDFIOError(f"SDF file truncated: {filename}")
    phi = np.frombuffer(raw, dtype="<f4", count=count, offset=HEADER_BYTES)
    phi = phi.reshape(ni, nj, nk).copy()
    return phi, header["bounds_min"].copy(), header["bounds_max"].copy()
