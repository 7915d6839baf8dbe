"""VTK XML ImageData (.vti) writer — the optional output format the reference
CLI offers when built with VTK (``app/main.cpp:281-317``). Copy of
``sdfgenfast_tpu/io/vti.py``.

The reference's VTK path is a compile-time alternative (``#ifdef HAVE_VTK``):
when enabled, the CLI writes ``<base>[_sdf_{n}x{n}x{n}].vti`` instead of a
binary ``.sdf``. We reproduce that with a dependency-free writer: a .vti file
is plain XML with base64-encoded appended data ("binary" format = base64 of a
UInt32 byte-count header + the float payload).

Point ordering: VTI is x-fastest (i + ni*(j + nj*k)) — exactly the reference's
``Array3`` layout, which it streams out verbatim (``app/main.cpp:303-306``).
Our (ni, nj, nk) C-order grid is k-fastest, so we transpose before writing.

Note: the reference sets Origin to ``(ni*dx/2, nj*dx/2, nk*dx/2)``
(``app/main.cpp:294``) — a bug (it ignores the grid's actual origin). We write
the true grid origin instead; spacing and extents match.
"""

from __future__ import annotations

import base64

import numpy as np

__all__ = ["write_vti"]


def write_vti(filename: str, phi: np.ndarray, origin, dx: float,
              array_name: str = "Distance") -> None:
    """Write an (ni, nj, nk) float32 grid as VTK XML ImageData."""
    phi = np.asarray(phi)
    if phi.ndim != 3:
        raise ValueError("SDF array must be 3-dimensional")
    if 0 in phi.shape:
        raise ValueError("SDF array dimensions cannot be zero")
    ni, nj, nk = phi.shape
    origin = np.asarray(origin, dtype=np.float64)
    # x-fastest point order (VTK convention; matches Array3, app/main.cpp:303)
    payload = np.ascontiguousarray(phi.transpose(2, 1, 0), dtype="<f4").tobytes()
    header = np.uint32(len(payload)).tobytes()
    b64 = base64.b64encode(header + payload).decode("ascii")

    extent = f"0 {ni - 1} 0 {nj - 1} 0 {nk - 1}"
    with open(filename, "w") as fh:
        fh.write('<?xml version="1.0"?>\n')
        fh.write(
            '<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" '
            'header_type="UInt32">\n'
        )
        fh.write(
            f'  <ImageData WholeExtent="{extent}" '
            f'Origin="{origin[0]:.9g} {origin[1]:.9g} {origin[2]:.9g}" '
            f'Spacing="{dx:.9g} {dx:.9g} {dx:.9g}">\n'
        )
        fh.write(f'    <Piece Extent="{extent}">\n')
        fh.write(f'      <PointData Scalars="{array_name}">\n')
        fh.write(
            f'        <DataArray type="Float32" Name="{array_name}" '
            'format="binary">\n'
        )
        fh.write(f"          {b64}\n")
        fh.write("        </DataArray>\n")
        fh.write("      </PointData>\n")
        fh.write("    </Piece>\n")
        fh.write("  </ImageData>\n")
        fh.write("</VTKFile>\n")
