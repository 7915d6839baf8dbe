"""Narrow-band tile evaluation over CSR candidate segments (kernel K2).

Counterpart of ``sdfgenfast_tpu/ops/band_pallas.py``. For every active 8^3
tile, each cell takes the exact squared distance to every candidate triangle
of the tile's CSR segment (plane distance for barycentric-inside cells,
cancellation-free clamped-edge differences otherwise, the same evaluation as
``cpu_lib/makelevelset3.cpp:21-70``), keeps the LOWEST candidate id among
ties (segments are ascending, so a strict '<' walk is first-wins), and emits
phi, the winner id and its closest point p - dd.

``band_rows`` launches the CUDA kernel (``csrc/band_rows.cu``) for CUDA
tensors and runs ``band_rows_reference``, its plain-torch twin, for CPU
tensors. ``band_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .vdt import FAR, sqrt_f32

__all__ = ["band_csr_from_binning", "band_rows", "band_rows_reference",
           "CHUNK"]

CHUNK = 16  # CSR segment granularity (kept from the JAX package's layout)
TILE_CELLS = 512  # 8 x 8 x 8


def band_csr_from_binning(cand, cand_valid, num_tris):
    """(A, K) padded candidate lists -> CSR arrays for the kernel.

    Returns (pair_cand (P,) int32, off (A,) int32, cnt (A,) int32) with each
    tile's segment padded to a CHUNK multiple using sentinel id `num_tris`
    (never a winner: the kernels skip ids >= num_tris).
    """
    counts = cand_valid.sum(axis=1).astype(np.int64)
    padded = -(-np.maximum(counts, 1) // CHUNK) * CHUNK
    off = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    # binning emits PREFIX-dense rows (valid[i, :counts[i]] all True), so a
    # segment is just the row prefix + sentinel pad — one boolean mask over
    # the (A, Kp) grid builds the whole CSR array
    A, K = cand.shape
    Kp = max(K, int(padded.max()) if A else CHUNK)
    cols = np.arange(Kp)
    vals = np.where(cols[None, :] < counts[:, None],
                    np.pad(cand, ((0, 0), (0, Kp - K))), num_tris)
    pair = vals[cols[None, :] < padded[:, None]].astype(np.int32)
    return pair, off.astype(np.int32), padded.astype(np.int32)


def _upper(grid_shape, dx):
    """The reference's init upper bound (ni+nj+nk)*dx in float32
    (makelevelset3.cpp:197)."""
    return np.float32(sum(grid_shape)) * np.float32(dx)


def _filled_rows(T, upper, device):
    """Five (T+1, 512) row arrays holding the no-candidate values; row T is
    the junk target of padded active-tile slots."""
    shape = (T + 1, TILE_CELLS)
    return (torch.full(shape, float(upper), dtype=torch.float32, device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device),
            *(torch.full(shape, float(FAR), dtype=torch.float32, device=device)
              for _ in range(3)))


def _check_args(tri9, pair, ids, off, cnt):
    if tri9.dtype != torch.float32 or tri9.dim() != 2 or tri9.shape[1] != 9:
        raise ValueError(f"tri9 must be (M, 9) float32, got "
                         f"{tuple(tri9.shape)} {tri9.dtype}")
    for name, t in (("pair", pair), ("ids", ids), ("off", off), ("cnt", cnt)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != tri9.device:
            raise ValueError(f"{name} is on {t.device}, tri9 on {tri9.device}")
    if not (ids.shape == off.shape == cnt.shape):
        raise ValueError("ids, off and cnt must have one entry per tile slot")


def band_rows_reference(tri9, pair, ids, off, cnt, dx: float, *, tiles_dim,
                        grid_shape):
    """Plain-torch twin of :func:`band_rows`: the k-th candidate of every
    tile segment is evaluated for all 512 cells at once, k = 0, 1, ..., and
    merged with a strict '<' — the kernel's walk, vectorized over tiles."""
    dev = tri9.device
    M = tri9.shape[0]
    nti, ntj, ntk = tiles_dim
    T = nti * ntj * ntk
    upper = _upper(grid_shape, dx)
    rows = _filled_rows(T, upper, dev)
    A = ids.shape[0]
    if A == 0:
        return rows

    t = ids.to(torch.int64)
    c = torch.arange(TILE_CELLS, device=dev)
    x = ((t // (ntk * ntj))[:, None] * 8 + c // 64).to(torch.float32) * dx
    y = (((t // ntk) % ntj)[:, None] * 8 + (c // 8) % 8).to(torch.float32) * dx
    z = ((t % ntk)[:, None] * 8 + c % 8).to(torch.float32) * dx

    best = torch.full((A, TILE_CELLS), float("inf"), device=dev)
    best_t = torch.full((A, TILE_CELLS), -1, dtype=torch.int32, device=dev)
    bdx = torch.zeros((A, TILE_CELLS), device=dev)
    bdy = torch.zeros_like(bdx)
    bdz = torch.zeros_like(bdx)

    off64 = off.to(torch.int64)
    cnt64 = cnt.to(torch.int64)
    table = torch.cat([tri9, torch.zeros((1, 9), dtype=tri9.dtype, device=dev)])
    P = pair.shape[0]
    for k in range(int(cnt.max()) if P else 0):
        cid = pair[(off64 + k).clamp(max=P - 1)].to(torch.int64)
        live = (k < cnt64) & (cid >= 0) & (cid < M)
        v = table[torch.where(live, cid, M)]  # (A, 9)
        ax, ay, az, bx, by, bz, cx, cy, cz = (v[:, i:i + 1] for i in range(9))

        def edge_coef(x1x, x1y, x1z, x2x, x2y, x2z):
            wx, wy, wz = x1x - x2x, x1y - x2y, x1z - x2z
            m2 = wx * wx + wy * wy + wz * wz
            inv = torch.reciprocal(torch.clamp(m2, min=1e-30))
            e0 = -(x2x * wx + x2y * wy + x2z * wz) * inv
            return (wx, wy, wz), (wx * inv, wy * inv, wz * inv, e0)

        w_ab, e_ab = edge_coef(ax, ay, az, bx, by, bz)
        w_ac, e_ac = edge_coef(ax, ay, az, cx, cy, cz)
        w_bc, e_bc = edge_coef(bx, by, bz, cx, cy, cz)

        x13x, x13y, x13z = ax - cx, ay - cy, az - cz
        x23x, x23y, x23z = bx - cx, by - cy, bz - cz
        m13 = x13x * x13x + x13y * x13y + x13z * x13z
        m23 = x23x * x23x + x23y * x23y + x23z * x23z
        d = x13x * x23x + x13y * x23y + x13z * x23z
        invdet = torch.reciprocal(torch.clamp(m13 * m23 - d * d, min=1e-30))
        g23x = invdet * (m23 * x13x - d * x23x)
        g23y = invdet * (m23 * x13y - d * x23y)
        g23z = invdet * (m23 * x13z - d * x23z)
        g23c = -(g23x * cx + g23y * cy + g23z * cz)
        g31x = invdet * (m13 * x23x - d * x13x)
        g31y = invdet * (m13 * x23y - d * x13y)
        g31z = invdet * (m13 * x23z - d * x13z)
        g31c = -(g31x * cx + g31y * cy + g31z * cz)

        crx = x13y * x23z - x13z * x23y
        cry = x13z * x23x - x13x * x23z
        crz = x13x * x23y - x13y * x23x
        cr2 = crx * crx + cry * cry + crz * crz
        rn = torch.rsqrt(torch.clamp(cr2, min=1e-37))
        nx, ny, nz = crx * rn, cry * rn, crz * rn
        h0 = -(nx * cx + ny * cy + nz * cz)
        degen = cr2 <= 1e-30

        h = nx * x + ny * y + nz * z + h0
        w23 = g23x * x + g23y * y + g23z * z + g23c
        w31 = g31x * x + g31y * y + g31z * z + g31c
        w12 = 1.0 - w23 - w31
        inside = (torch.minimum(torch.minimum(w23, w31), w12) >= 0.0) & ~degen

        def edge_d2(e, w, ux, uy, uz):
            ex, ey, ez, e0 = e
            wx, wy, wz = w
            s = torch.clamp(ex * x + ey * y + ez * z + e0, 0.0, 1.0)
            ddx, ddy, ddz = ux - s * wx, uy - s * wy, uz - s * wz
            return ddx * ddx + ddy * ddy + ddz * ddz, (ddx, ddy, ddz)

        dab, dd_ab = edge_d2(e_ab, w_ab, x - bx, y - by, z - bz)
        ucx, ucy, ucz = x - cx, y - cy, z - cz
        dac, dd_ac = edge_d2(e_ac, w_ac, ucx, ucy, ucz)
        dbc, dd_bc = edge_d2(e_bc, w_bc, ucx, ucy, ucz)
        d2 = torch.where(inside, h * h,
                         torch.minimum(dab, torch.minimum(dac, dbc)))
        ab_best = (dab <= dac) & (dab <= dbc)
        ac_best = ~ab_best & (dac <= dbc)

        better = live[:, None] & (d2 < best)
        best = torch.where(better, d2, best)
        best_t = torch.where(better, cid.to(torch.int32)[:, None], best_t)
        for b, i3, nrm in ((bdx, 0, nx), (bdy, 1, ny), (bdz, 2, nz)):
            e = torch.where(ab_best, dd_ab[i3],
                            torch.where(ac_best, dd_ac[i3], dd_bc[i3]))
            b.copy_(torch.where(better, torch.where(inside, h * nrm, e), b))

    has = best < float(upper * upper)
    phi_r, tid_r, cpx_r, cpy_r, cpz_r = rows
    phi_r[t] = torch.where(has, sqrt_f32(best), float(upper))
    tid_r[t] = torch.where(has, best_t, -1)
    cpx_r[t] = torch.where(has, x - bdx, float(FAR))
    cpy_r[t] = torch.where(has, y - bdy, float(FAR))
    cpz_r[t] = torch.where(has, z - bdz, float(FAR))
    return rows


def band_rows(tri9, pair, ids, off, cnt, dx: float, *, tiles_dim, grid_shape):
    """(T+1, 512) rows of (phi f32, tid int32, cpx, cpy, cpz f32).

    tri9: (M, 9) float32 GRID-LOCAL triangle vertices (origin subtracted);
    pair: (P,) int32 CSR candidate ids (ids >= M are padding); ids: (A,)
    int32 linear tile ids (T for padded slots); off/cnt: (A,) int32 segment
    starts and lengths. Rows of tiles that are not active hold the
    no-candidate values (upper, -1, FAR); row T is junk.
    CUDA: one K2 launch. CPU: :func:`band_rows_reference`.
    """
    _check_args(tri9, pair, ids, off, cnt)
    if tri9.device.type == "cpu":
        return band_rows_reference(tri9, pair, ids, off, cnt, dx,
                                   tiles_dim=tiles_dim, grid_shape=grid_shape)
    if tri9.device.type != "cuda":
        raise ValueError(f"band_rows: unsupported device {tri9.device}")
    tri9, pair, ids, off, cnt = (a.contiguous() for a in (tri9, pair, ids,
                                                          off, cnt))
    nti, ntj, ntk = tiles_dim
    T = nti * ntj * ntk
    rows = _filled_rows(T, _upper(grid_shape, dx), tri9.device)
    lib = build.library()
    with torch.cuda.device(tri9.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.sdf_band_rows(
            tri9.data_ptr(), tri9.shape[0], pair.data_ptr(), ids.data_ptr(),
            off.data_ptr(), cnt.data_ptr(), ids.shape[0], ntj, ntk,
            int(sum(grid_shape)), float(dx),
            *(r.data_ptr() for r in rows), stream), "sdf_band_rows")
    band_rows.launches += 1
    return rows


band_rows.launches = 0
