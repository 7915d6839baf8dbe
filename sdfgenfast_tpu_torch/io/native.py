"""ctypes bindings for the native C++ I/O library (csrc/sdfgenio.cpp).

Copy of ``sdfgenfast_tpu/io/native.py``: both packages load the one
repository-root ``csrc/libsdfgenio.so`` (this module sits at the same depth,
so the path logic is unchanged).

The reference's I/O layer is C++ (common/mesh_io_*.cpp, sdf_io.cpp); ours is
too — this module loads ``libsdfgenio.so``, building it on first use with the
checked-in Makefile if necessary. Falls back cleanly (``available() ->
False``) when no compiler is present; callers then use the NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libsdfgenio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class NativeIOError(RuntimeError):
    pass


def _build() -> bool:
    try:
        r = subprocess.run(
            ["make", "-C", _CSRC], capture_output=True, text=True, timeout=120
        )
        return r.returncode == 0 and os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        c = ctypes
        lib.sdfgenio_free.argtypes = [c.c_void_p]
        for name in ("sdfgenio_load_obj", "sdfgenio_load_stl"):
            fn = getattr(lib, name)
            fn.restype = c.c_int
            fn.argtypes = [
                c.c_char_p,
                c.POINTER(c.POINTER(c.c_float)),
                c.POINTER(c.POINTER(c.c_uint32)),
                c.POINTER(c.c_int64),
                c.POINTER(c.c_int64),
                c.c_char_p,
                c.c_int,
            ]
        lib.sdfgenio_write_sdf.restype = c.c_int
        lib.sdfgenio_write_sdf.argtypes = [
            c.c_char_p, c.POINTER(c.c_float), c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_float), c.c_float, c.POINTER(c.c_int64),
            c.c_char_p, c.c_int,
        ]
        lib.sdfgenio_read_sdf.restype = c.c_int
        lib.sdfgenio_read_sdf.argtypes = [
            c.c_char_p, c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.c_int32), c.POINTER(c.c_float),
            c.c_char_p, c.c_int,
        ]
        if hasattr(lib, "sdfgenio_parity_packed"):
            lib.sdfgenio_parity_packed.restype = c.c_int
            lib.sdfgenio_parity_packed.argtypes = [
                c.POINTER(c.c_float), c.c_int64,
                c.POINTER(c.c_uint32), c.c_int64,
                c.POINTER(c.c_double), c.c_double,
                c.c_int32, c.c_int32, c.c_int32,
                c.POINTER(c.c_uint8), c.c_int,
                c.c_char_p, c.c_int,
            ]
        if hasattr(lib, "sdfbin_count"):
            lib.sdfbin_count.restype = c.c_int
            lib.sdfbin_count.argtypes = [
                c.POINTER(c.c_float), c.c_int64,
                c.POINTER(c.c_uint32), c.c_int64,
                c.POINTER(c.c_double), c.c_double,
                c.c_int32, c.c_int32, c.c_int32,
                c.c_int32, c.c_int32, c.c_int32, c.c_int32,
                c.c_int32,  # prune
                c.POINTER(c.c_int64),
                c.POINTER(c.c_int64), c.POINTER(c.c_int64),
                c.c_char_p, c.c_int,
            ]
            lib.sdfbin_fill.restype = c.c_int
            lib.sdfbin_fill.argtypes = [
                c.POINTER(c.c_float), c.c_int64,
                c.POINTER(c.c_uint32), c.c_int64,
                c.POINTER(c.c_double), c.c_double,
                c.c_int32, c.c_int32, c.c_int32,
                c.c_int32, c.c_int32, c.c_int32, c.c_int32,
                c.c_int32,  # prune
                c.POINTER(c.c_int64), c.c_int64,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                c.POINTER(c.c_uint8),
                c.c_char_p, c.c_int,
            ]
        if hasattr(lib, "sdfgenio_crossings"):
            lib.sdfgenio_crossings.restype = c.c_int
            lib.sdfgenio_crossings.argtypes = [
                c.POINTER(c.c_float), c.c_int64,
                c.POINTER(c.c_uint32), c.c_int64,
                c.POINTER(c.c_double), c.c_double,
                c.c_int32, c.c_int32, c.c_int32,
                c.POINTER(c.c_int16), c.c_int32, c.POINTER(c.c_int32),
                c.c_int, c.c_char_p, c.c_int,
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _take_array(ptr, count, dtype, lib):
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)
    lib.sdfgenio_free(ctypes.cast(ptr, ctypes.c_void_p))
    return arr


def _load_mesh_impl(fn_name: str, path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise NativeIOError("native IO library unavailable")
    c = ctypes
    verts_p = c.POINTER(c.c_float)()
    tris_p = c.POINTER(c.c_uint32)()
    nv = c.c_int64()
    nt = c.c_int64()
    err = c.create_string_buffer(256)
    rc = getattr(lib, fn_name)(
        path.encode(), c.byref(verts_p), c.byref(tris_p), c.byref(nv),
        c.byref(nt), err, 256,
    )
    if rc != 0:
        raise NativeIOError(err.value.decode() or f"{fn_name} failed ({rc})")
    verts = _take_array(verts_p, nv.value * 3, np.float32, lib).reshape(-1, 3)
    tris = _take_array(tris_p, nt.value * 3, np.uint32, lib).reshape(-1, 3)
    return verts, tris


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    return _load_mesh_impl("sdfgenio_load_obj", path)


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    return _load_mesh_impl("sdfgenio_load_stl", path)


def write_sdf(path: str, phi: np.ndarray, origin, dx: float) -> int:
    lib = _load()
    if lib is None:
        raise NativeIOError("native IO library unavailable")
    c = ctypes
    phi32 = np.ascontiguousarray(phi, dtype=np.float32)
    origin32 = np.ascontiguousarray(np.asarray(origin, np.float32))
    inside = c.c_int64()
    err = c.create_string_buffer(256)
    rc = lib.sdfgenio_write_sdf(
        path.encode(),
        phi32.ctypes.data_as(c.POINTER(c.c_float)),
        phi32.shape[0], phi32.shape[1], phi32.shape[2],
        origin32.ctypes.data_as(c.POINTER(c.c_float)),
        c.c_float(dx), c.byref(inside), err, 256,
    )
    if rc != 0:
        raise NativeIOError(err.value.decode() or f"write_sdf failed ({rc})")
    return int(inside.value)


def parity_packed(verts: np.ndarray, tris: np.ndarray, origin, dx: float,
                  shape, num_threads: int = 0) -> Optional[np.ndarray]:
    """Native exact-f64 x-ray parity, bit-packed along i: the output of
    ``sign_host.pack_parity(parity_field_host(...))``. Returns None when the
    native library (or the symbol) is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sdfgenio_parity_packed"):
        return None
    c = ctypes
    ni, nj, nk = (int(v) for v in shape)
    verts32 = np.ascontiguousarray(verts, dtype=np.float32)
    tris32 = np.ascontiguousarray(tris, dtype=np.uint32)
    origin64 = np.ascontiguousarray(np.asarray(origin, np.float64))
    packed = np.zeros(((ni + 7) // 8, nj, nk), dtype=np.uint8)
    err = c.create_string_buffer(256)
    rc = lib.sdfgenio_parity_packed(
        verts32.ctypes.data_as(c.POINTER(c.c_float)), len(verts32),
        tris32.ctypes.data_as(c.POINTER(c.c_uint32)), len(tris32),
        origin64.ctypes.data_as(c.POINTER(c.c_double)),
        c.c_double(float(np.float64(np.float32(dx)))),
        ni, nj, nk,
        packed.ctypes.data_as(c.POINTER(c.c_uint8)), num_threads,
        err, 256,
    )
    if rc != 0:
        raise NativeIOError(err.value.decode() or f"parity_packed failed ({rc})")
    return packed


def crossings(
    verts: np.ndarray, tris: np.ndarray, origin, dx: float,
    shape, cap: int = 8, num_threads: int = 0,
) -> Optional[Tuple[np.ndarray, int]]:
    """Native exact-f64 x-ray crossing positions: a ((cap, nj, nk) int16,
    max_count) pair with sentinel 32767 padding; grows cap as needed.
    Returns None when the native library (or the symbol) is unavailable.
    Requires ni <= 32766 (crossing positions are int16)."""
    if int(shape[0]) > 32766:
        raise ValueError("crossings requires ni <= 32766 (int16 positions)")
    lib = _load()
    if lib is None or not hasattr(lib, "sdfgenio_crossings"):
        return None
    c = ctypes
    ni, nj, nk = (int(v) for v in shape)
    verts32 = np.ascontiguousarray(verts, dtype=np.float32)
    tris32 = np.ascontiguousarray(tris, dtype=np.uint32)
    origin64 = np.ascontiguousarray(np.asarray(origin, np.float64))
    err = c.create_string_buffer(256)
    while True:
        out = np.empty((cap, nj, nk), dtype=np.int16)
        maxc = c.c_int32(0)
        rc = lib.sdfgenio_crossings(
            verts32.ctypes.data_as(c.POINTER(c.c_float)), len(verts32),
            tris32.ctypes.data_as(c.POINTER(c.c_uint32)), len(tris32),
            origin64.ctypes.data_as(c.POINTER(c.c_double)),
            c.c_double(float(np.float64(np.float32(dx)))),
            ni, nj, nk,
            out.ctypes.data_as(c.POINTER(c.c_int16)), cap, c.byref(maxc),
            num_threads, err, 256,
        )
        if rc != 0:
            raise NativeIOError(err.value.decode() or f"crossings failed ({rc})")
        if maxc.value <= cap:
            return out, int(maxc.value)
        cap = -(-int(maxc.value) // 4) * 4


def read_sdf(path: str):
    lib = _load()
    if lib is None:
        raise NativeIOError("native IO library unavailable")
    c = ctypes
    data_p = c.POINTER(c.c_float)()
    dims = (c.c_int32 * 3)()
    bounds = (c.c_float * 6)()
    err = c.create_string_buffer(256)
    rc = lib.sdfgenio_read_sdf(path.encode(), c.byref(data_p), dims, bounds, err, 256)
    if rc != 0:
        raise NativeIOError(err.value.decode() or f"read_sdf failed ({rc})")
    ni, nj, nk = dims[0], dims[1], dims[2]
    phi = _take_array(data_p, ni * nj * nk, np.float32, lib).reshape(ni, nj, nk)
    bmin = np.array(bounds[0:3], np.float32)
    bmax = np.array(bounds[3:6], np.float32)
    return phi, bmin, bmax


def bin_triangles_native(verts: np.ndarray, tris: np.ndarray, origin,
                         dx: float, shape, band: int, tile_shape,
                         pad_k_to: int = 8, prune: bool = True):
    """Native two-pass band binning (csrc/sdfbin.cpp); bit-identical to the
    NumPy path in ops/band.bin_triangles. Returns (active_ids, cand, valid,
    tiles_dim) or None when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "sdfbin_count"):
        return None
    c = ctypes
    ni, nj, nk = (int(v) for v in shape)
    ti, tj, tk = (int(v) for v in tile_shape)
    nti, ntj, ntk = -(-ni // ti), -(-nj // tj), -(-nk // tk)
    verts32 = np.ascontiguousarray(verts, dtype=np.float32)
    tris32 = np.ascontiguousarray(tris, dtype=np.uint32)
    origin64 = np.ascontiguousarray(np.asarray(origin, np.float64))
    dx64 = float(np.float64(np.float32(dx)))
    counts = np.zeros(nti * ntj * ntk, np.int64)
    a_out = c.c_int64()
    k_out = c.c_int64()
    err = c.create_string_buffer(256)
    rc = lib.sdfbin_count(
        verts32.ctypes.data_as(c.POINTER(c.c_float)), len(verts32),
        tris32.ctypes.data_as(c.POINTER(c.c_uint32)), len(tris32),
        origin64.ctypes.data_as(c.POINTER(c.c_double)), dx64,
        ni, nj, nk, band, ti, tj, tk, int(prune),
        counts.ctypes.data_as(c.POINTER(c.c_int64)),
        c.byref(a_out), c.byref(k_out), err, 256,
    )
    if rc != 0:
        raise NativeIOError(err.value.decode() or f"sdfbin_count failed ({rc})")
    A = int(a_out.value)
    K = max(int(k_out.value), 1)
    K = -(-K // pad_k_to) * pad_k_to
    if A == 0:
        return (np.zeros((0,), np.int32), np.zeros((0, K), np.int32),
                np.zeros((0, K), bool), (nti, ntj, ntk))
    active = np.empty(A, np.int32)
    cand = np.zeros((A, K), np.int32)
    valid = np.zeros((A, K), np.uint8)
    rc = lib.sdfbin_fill(
        verts32.ctypes.data_as(c.POINTER(c.c_float)), len(verts32),
        tris32.ctypes.data_as(c.POINTER(c.c_uint32)), len(tris32),
        origin64.ctypes.data_as(c.POINTER(c.c_double)), dx64,
        ni, nj, nk, band, ti, tj, tk, int(prune),
        counts.ctypes.data_as(c.POINTER(c.c_int64)), K,
        active.ctypes.data_as(c.POINTER(c.c_int32)),
        cand.ctypes.data_as(c.POINTER(c.c_int32)),
        valid.ctypes.data_as(c.POINTER(c.c_uint8)),
        err, 256,
    )
    if rc != 0:
        raise NativeIOError(err.value.decode() or f"sdfbin_fill failed ({rc})")
    return active, cand, valid.astype(bool), (nti, ntj, ntk)
