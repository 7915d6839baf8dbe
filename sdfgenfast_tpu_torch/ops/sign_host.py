"""Host-side x-ray parity: vectorized NumPy float64, bit-exact with the
reference's double-precision SOS predicates (cpu_lib/makelevelset3.cpp:155-187,
222-235, 295-303).

Copy of ``sdfgenfast_tpu/ops/sign_host.py``: the host functions are the same
code; the two device halves (``parity_from_crossings_device``,
``unpack_parity_device``) are plain torch ops on the device the caller's
tensor lives on.

Why host: the parity field is non-differentiable (piecewise constant in the
vertex positions) and is consumed once per binning — the same lifecycle as the
host-side triangle binning. Computing it here in true float64 gives exact
reference parity. (The JAX package's device predicates,
``SDFConfig(sign_mode="device")``, are not ported.)

Vectorization: triangles are bucketed by rasterized (j, k) bbox size; each
bucket is evaluated as one (Mb, bj, bk) batch and accumulated into the global
count-parity via XOR of per-bucket bincounts (parity(a+b) = parity(a) XOR
parity(b)). The per-column prefix parity along i is a cumulative XOR.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec
from .band import triangle_grid_coords

__all__ = [
    "parity_field_host",
    "parity_packed_host",
    "pack_parity",
    "unpack_parity_device",
    "CROSS_SENTINEL",
    "crossings_host",
    "parity_from_crossings_device",
]

# int16 sentinel for "no crossing": greater than any valid i index, so the
# device-side (i >= cross) compare contributes nothing to the parity XOR
CROSS_SENTINEL = np.int16(32767)


def crossings_host(verts: np.ndarray, tris: np.ndarray, grid: GridSpec,
                   num_threads: int = 0, min_rows: int = 0) -> np.ndarray:
    """(C, nj, nk) int16 per-column x-ray crossing positions (sentinel-padded,
    C bucketed to a multiple of 2 as in the JAX package, so the transports
    stay byte-equal; `min_rows` pads further).

    A crossing at position c means the parity field toggles at i = c:
    parity(i, j, k) = XOR_c [i >= crossings(c, j, k)] — the exact prefix-XOR
    of the reference's intersection counting (cpu_lib/makelevelset3.cpp:
    295-303), but shipped to the device as a few compares worth of data
    (~C/ni * 1/8 the bytes of the bit-packed parity field). The "auto"
    transport keeps whichever of the two encodings is smaller."""
    from ..io import native

    ni, nj, nk = grid.shape
    if ni > 32766:
        raise ValueError("crossings_host requires ni <= 32766 (int16 positions)")
    out = None
    try:
        res = native.crossings(
            verts, tris, grid.origin, float(np.float32(grid.dx)), grid.shape,
            num_threads=num_threads,
        )
        if res is not None:
            out, maxc = res
    except native.NativeIOError:
        out = None
    if out is None:
        parity = parity_field_host(verts, tris, grid)
        ev = parity.copy()
        ev[1:] ^= parity[:-1]
        ii, jj, kk = np.nonzero(ev)  # C-order: i ascending within a column
        col = jj.astype(np.int64) * nk + kk
        order = np.argsort(col, kind="stable")
        col = col[order]
        ii = ii[order]
        uniq, starts, per = np.unique(col, return_index=True, return_counts=True)
        maxc = int(per.max()) if len(per) else 0
        out = np.full((max(maxc, 1), nj, nk), CROSS_SENTINEL, np.int16)
        rank = np.arange(len(col)) - np.repeat(starts, per)
        out[rank, col // nk, col % nk] = ii.astype(np.int16)
    C = max(2, -(-max(int(maxc), 1) // 2) * 2, int(min_rows))
    if out.shape[0] < C:
        pad = np.full((C - out.shape[0], nj, nk), CROSS_SENTINEL, np.int16)
        out = np.concatenate([out, pad], axis=0)
    return out[:C]


def parity_from_crossings_device(crossings, ni: int):
    """Device-side parity reconstruction: (C, nj, nk) int16 tensor ->
    (ni, nj, nk) bool via an XOR chain of per-crossing compares (C is small,
    2-8 after the auto-transport size check)."""
    i = torch.arange(ni, dtype=torch.int32,
                     device=crossings.device).reshape(ni, 1, 1)
    cr = crossings.to(torch.int32)
    acc = i >= cr[0]
    for c in range(1, crossings.shape[0]):
        acc = acc ^ (i >= cr[c])
    return acc


def packed_from_crossings(cross: np.ndarray, ni: int) -> np.ndarray:
    """Bit-packed parity field reconstructed from crossing positions.

    Exactly `pack_parity(parity)` for the parity field the crossings encode
    (each crossing toggles its column's parity from row c on; duplicate
    positions cancel via the bincount parity). Lets the "auto" transport
    compute the SOS predicates ONCE — the packed field, when it wins the
    size comparison, is derived from the already-computed crossings instead
    of re-running the full predicate pass."""
    C, nj, nk = cross.shape
    c = cross.astype(np.int64)
    jj = np.arange(nj, dtype=np.int64)[None, :, None]
    kk = np.arange(nk, dtype=np.int64)[None, None, :]
    sel = c < ni  # sentinel (and out-of-range) entries toggle nothing
    flat = (c * nj + jj) * nk + kk
    bc = np.bincount(flat[sel], minlength=ni * nj * nk)
    ev = (bc & 1).astype(bool).reshape(ni, nj, nk)
    return pack_parity(np.logical_xor.accumulate(ev, axis=0))


def parity_packed_host(verts: np.ndarray, tris: np.ndarray, grid: GridSpec,
                       num_threads: int = 0) -> np.ndarray:
    """Bit-packed parity field, preferring the native C++ kernel.

    The native path (csrc/sdfparity.cpp) computes the identical f64 SOS
    predicates triangle-parallel and emits the packed layout directly; the
    NumPy code below is the fallback when the library is unavailable."""
    from ..io import native

    try:
        packed = native.parity_packed(
            verts, tris, grid.origin,
            float(np.float32(grid.dx)), grid.shape, num_threads,
        )
    except native.NativeIOError:
        packed = None
    if packed is not None:
        return packed
    return pack_parity(parity_field_host(verts, tris, grid))


def _orientation(x1, y1, x2, y2):
    """f64 SOS orientation, elementwise (makelevelset3.cpp:155-165)."""
    area = y1 * x2 - x1 * y2
    s = np.sign(area)
    tie = np.where(
        y2 > y1, 1.0, np.where(y2 < y1, -1.0, np.where(x1 > x2, 1.0, np.where(x1 < x2, -1.0, 0.0)))
    )
    return np.where(s != 0, s, tie), area


def parity_field_host(verts: np.ndarray, tris: np.ndarray, grid: GridSpec) -> np.ndarray:
    """(ni, nj, nk) bool: True = odd x-ray crossings so far = inside."""
    ni, nj, nk = grid.shape
    f = triangle_grid_coords(verts, tris, grid)  # (M, 3, 3) float64
    fi = f[:, :, 0]
    fj = f[:, :, 1]
    fk = f[:, :, 2]

    j0 = np.clip(np.ceil(fj.min(1)), 0, nj - 1).astype(np.int64)
    j1 = np.clip(np.floor(fj.max(1)), 0, nj - 1).astype(np.int64)
    k0 = np.clip(np.ceil(fk.min(1)), 0, nk - 1).astype(np.int64)
    k1 = np.clip(np.floor(fk.max(1)), 0, nk - 1).astype(np.int64)
    sj = j1 - j0 + 1
    sk = k1 - k0 + 1
    nonempty = (sj > 0) & (sk > 0)

    parity_bins = np.zeros(ni * nj * nk, dtype=bool)

    # bucket by padded bbox size to bound the number of batch shapes
    def bucket_size(s):
        return 1 << int(np.ceil(np.log2(max(int(s), 1))))

    order = np.flatnonzero(nonempty)
    if len(order) == 0:
        return parity_bins.reshape(ni, nj, nk)
    keys = [(bucket_size(sj[t]), bucket_size(sk[t])) for t in order]
    buckets: dict = {}
    for t, key in zip(order, keys):
        buckets.setdefault(key, []).append(t)

    for (bj, bk), ts in buckets.items():
        ts = np.asarray(ts)
        jj = j0[ts, None, None] + np.arange(bj)[None, :, None]  # (Mb, bj, 1)
        kk = k0[ts, None, None] + np.arange(bk)[None, None, :]  # (Mb, 1, bk)
        in_box = (jj <= j1[ts, None, None]) & (kk <= k1[ts, None, None])
        jj = jj.astype(np.float64)
        kk = kk.astype(np.float64)

        x1 = fj[ts, 0, None, None] - jj
        y1 = fk[ts, 0, None, None] - kk
        x2 = fj[ts, 1, None, None] - jj
        y2 = fk[ts, 1, None, None] - kk
        x3 = fj[ts, 2, None, None] - jj
        y3 = fk[ts, 2, None, None] - kk
        sa, a = _orientation(x2, y2, x3, y3)
        sb, b = _orientation(x3, y3, x1, y1)
        sc, c = _orientation(x1, y1, x2, y2)
        inside = (sa != 0) & (sb == sa) & (sc == sa) & in_box
        total = a + b + c
        total = np.where(total == 0.0, 1.0, total)
        fint = (a * fi[ts, 0, None, None] + b * fi[ts, 1, None, None] + c * fi[ts, 2, None, None]) / total
        bins = np.ceil(fint).astype(np.int64)
        sel = inside & (bins < ni)  # >= ni dropped (makelevelset3.cpp:233)
        if not sel.any():
            continue
        bins = np.clip(bins, 0, ni - 1)  # < 0 counted at interval 0 (:231)
        jj_i = (j0[ts, None, None] + np.arange(bj)[None, :, None]).astype(np.int64)
        kk_i = (k0[ts, None, None] + np.arange(bk)[None, None, :]).astype(np.int64)
        jj_b = np.broadcast_to(jj_i, bins.shape)
        kk_b = np.broadcast_to(kk_i, bins.shape)
        flat = (bins[sel] * nj + jj_b[sel]) * nk + kk_b[sel]
        bc = np.bincount(flat, minlength=ni * nj * nk)
        parity_bins ^= (bc & 1).astype(bool)

    parity = np.logical_xor.accumulate(
        parity_bins.reshape(ni, nj, nk), axis=0
    )
    return parity


def pack_parity(parity: np.ndarray) -> np.ndarray:
    """Pack (ni, nj, nk) bool to (ceil(ni/8), nj, nk) uint8 (bitorder little)
    to cut host->device transfer 8x."""
    return np.packbits(parity, axis=0, bitorder="little")


def unpack_parity_device(packed, ni: int):
    """Device-side unpack of pack_parity output (uint8 tensor) back to
    (ni, nj, nk) bool."""
    bits = torch.arange(8, dtype=torch.uint8, device=packed.device)
    # (ceil(ni/8), 8, nj, nk) -> (ceil(ni/8)*8, nj, nk)
    expanded = (packed[:, None, :, :] >> bits[None, :, None, None]) & 1
    out = expanded.reshape(-1, packed.shape[1], packed.shape[2])
    return out[:ni].to(torch.bool)
