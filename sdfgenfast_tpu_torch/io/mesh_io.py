"""Mesh loaders: Wavefront OBJ and STL (binary + ASCII, auto-detected).
Copy of ``sdfgenfast_tpu/io/mesh_io.py``.

Behavioral parity targets (rebuilt, not translated):
- extension dispatch, case-insensitive          -> common/mesh_io.cpp:14-48
- OBJ: v / f lines; f supports v, v/vt, v/vt/vn, v//vn; quads and n-gons
  fan-triangulated; 1-based -> 0-based          -> common/mesh_io_obj.cpp:21-157
- STL format sniffing: "solid" prefix (case-insensitive) is only ASCII if the
  binary size equation 80+4+50*n does not hold  -> common/mesh_io_stl.cpp:42-92
- both STL loaders emit 3 duplicated vertices per triangle (no dedup)
                                                -> common/mesh_io_stl.cpp:140-166

Unlike the reference's line-at-a-time istream parsing, these loaders are
vectorized NumPy (binary STL is a single strided ``np.frombuffer``) with an
optional native C++ fast path for huge ASCII files (see ``io/native.py``).
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np

from ..mesh import Mesh

__all__ = ["load_obj", "load_stl", "load_mesh", "save_obj", "save_stl"]


class MeshLoadError(RuntimeError):
    pass


def _try_native(fn_name: str, filename: str):
    """Use the C++ fast path (io/native.py) when the library is buildable;
    None -> caller falls back to the NumPy implementation."""
    from . import native

    if not native.available():
        return None
    try:
        verts, tris = getattr(native, fn_name)(filename)
    except native.NativeIOError as e:
        raise MeshLoadError(f"{filename}: {e}") from e
    mesh = Mesh(verts, tris)
    mn, mx = mesh.bounds()
    return mesh, mn, mx


def _get_extension(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    return ext


def load_mesh(filename: str) -> Tuple[Mesh, np.ndarray, np.ndarray]:
    """Load .obj or .stl by extension. Returns (mesh, min_box, max_box)."""
    ext = _get_extension(filename)
    if ext == ".obj":
        return load_obj(filename)
    if ext == ".stl":
        return load_stl(filename)
    raise MeshLoadError(
        f"Unsupported mesh format '{ext}' for {filename} (expected .obj or .stl)"
    )


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

_FACE_INDEX_RE = re.compile(r"^(-?\d+)")


def load_obj(filename: str) -> Tuple[Mesh, np.ndarray, np.ndarray]:
    native_result = _try_native("load_obj", filename)
    if native_result is not None:
        return native_result
    verts: list = []
    faces: list = []
    try:
        fh = open(filename, "r", errors="replace")
    except OSError as e:
        raise MeshLoadError(f"Failed to open OBJ file: {filename}: {e}") from e
    with fh:
        for line in fh:
            if not line or line[0] not in "vf":
                continue
            if line[0] == "v":
                if len(line) > 1 and line[1] in " \t":
                    parts = line.split()
                    if len(parts) < 4:
                        continue
                    try:
                        verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
                    except ValueError:
                        continue
                # vn / vt ignored
            else:  # 'f'
                if len(line) > 1 and line[1] in " \t":
                    idxs = []
                    ok = True
                    for tok in line.split()[1:]:
                        m = _FACE_INDEX_RE.match(tok)
                        if not m:
                            ok = False
                            break
                        idxs.append(int(m.group(1)))
                    if not ok or len(idxs) < 3:
                        continue
                    # fan triangulation, 1-based -> 0-based
                    for t in range(1, len(idxs) - 1):
                        faces.append((idxs[0] - 1, idxs[t] - 1, idxs[t + 1] - 1))
    if not verts:
        raise MeshLoadError(f"No vertices found in OBJ file: {filename}")
    if not faces:
        raise MeshLoadError(f"No faces found in OBJ file: {filename}")
    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int64)
    # Negative OBJ indices are relative to current vertex count; the reference
    # simply casts to uint32 — we resolve the (rare) relative form properly.
    f = np.where(f < 0, f + 1 + len(verts), f).astype(np.uint32)
    mesh = Mesh(v, f)
    mn, mx = mesh.bounds()
    return mesh, mn, mx


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------

_STL_RECORD_DTYPE = np.dtype(
    [
        ("normal", "<f4", (3,)),
        ("verts", "<f4", (3, 3)),
        ("attr", "<u2"),
    ]
)  # 50 bytes, matching STL_TRIANGLE_SIZE (common/mesh_io_stl.cpp:23)


def _detect_stl_format(data: bytes) -> str:
    """'binary' | 'ascii' per the reference's sniffing rules
    (common/mesh_io_stl.cpp:42-92)."""
    if len(data) < 5:
        raise MeshLoadError("STL file too short to determine format")
    head = data[:80].lower()
    if head.startswith(b"solid"):
        if len(data) < 84:
            return "ascii"
        n = int(np.frombuffer(data[80:84], dtype="<u4")[0])
        expected = 80 + 4 + n * 50
        return "binary" if len(data) == expected else "ascii"
    return "binary"


def load_stl(filename: str) -> Tuple[Mesh, np.ndarray, np.ndarray]:
    native_result = _try_native("load_stl", filename)
    if native_result is not None:
        return native_result
    try:
        with open(filename, "rb") as fh:
            data = fh.read()
    except OSError as e:
        raise MeshLoadError(f"Failed to open STL file: {filename}: {e}") from e
    fmt = _detect_stl_format(data)
    if fmt == "binary":
        return _load_binary_stl(data, filename)
    return _load_ascii_stl(data, filename)


def _load_binary_stl(data: bytes, filename: str) -> Tuple[Mesh, np.ndarray, np.ndarray]:
    if len(data) < 84:
        raise MeshLoadError(f"Binary STL truncated: {filename}")
    n = int(np.frombuffer(data[80:84], dtype="<u4")[0])
    need = 84 + n * 50
    if len(data) < need:
        raise MeshLoadError(
            f"Binary STL truncated: {filename} (need {need} bytes, have {len(data)})"
        )
    records = np.frombuffer(data, dtype=_STL_RECORD_DTYPE, count=n, offset=84)
    verts = records["verts"].reshape(-1, 3).astype(np.float32)  # 3 verts per tri, dup'd
    tris = np.arange(3 * n, dtype=np.uint32).reshape(-1, 3)
    if n == 0:
        raise MeshLoadError(f"No faces found in STL file: {filename}")
    mesh = Mesh(verts, tris)
    mn, mx = mesh.bounds()
    return mesh, mn, mx


_ASCII_VERTEX_RE = re.compile(
    rb"vertex\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)", re.IGNORECASE
)


def _load_ascii_stl(data: bytes, filename: str) -> Tuple[Mesh, np.ndarray, np.ndarray]:
    # Vectorized: every "vertex x y z" line, in order; groups of 3 per facet.
    matches = _ASCII_VERTEX_RE.findall(data)
    if not matches:
        raise MeshLoadError(f"No vertices found in ASCII STL file: {filename}")
    if len(matches) % 3 != 0:
        raise MeshLoadError(
            f"ASCII STL facet has wrong vertex count in {filename}: "
            f"{len(matches)} vertices is not a multiple of 3"
        )
    try:
        verts = np.array(matches, dtype=np.float32)
    except ValueError as e:
        raise MeshLoadError(f"Failed to parse vertex in ASCII STL {filename}: {e}") from e
    tris = np.arange(len(verts), dtype=np.uint32).reshape(-1, 3)
    mesh = Mesh(verts, tris)
    mn, mx = mesh.bounds()
    return mesh, mn, mx


# ---------------------------------------------------------------------------
# Writers (used by tests and tooling; the reference ships only readers)
# ---------------------------------------------------------------------------


def save_obj(filename: str, mesh: Mesh) -> None:
    with open(filename, "w") as fh:
        for v in mesh.verts:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in mesh.tris:
            fh.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def save_stl(filename: str, mesh: Mesh, ascii_format: bool = False) -> None:
    tv = mesh.verts[mesh.tris.astype(np.int64)]  # (M, 3, 3)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    normals = np.cross(e1, e2)
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(norms > 0, normals / np.maximum(norms, 1e-30), 0.0)
    if ascii_format:
        with open(filename, "w") as fh:
            fh.write("solid mesh\n")
            for n, t in zip(normals, tv):
                fh.write(f"  facet normal {n[0]:e} {n[1]:e} {n[2]:e}\n")
                fh.write("    outer loop\n")
                for v in t:
                    fh.write(f"      vertex {v[0]:e} {v[1]:e} {v[2]:e}\n")
                fh.write("    endloop\n  endfacet\n")
            fh.write("endsolid mesh\n")
    else:
        records = np.zeros(len(tv), dtype=_STL_RECORD_DTYPE)
        records["normal"] = normals.astype(np.float32)
        records["verts"] = tv.astype(np.float32)
        with open(filename, "wb") as fh:
            fh.write(b"\x00" * 80)
            fh.write(np.uint32(len(tv)).tobytes())
            fh.write(records.tobytes())
