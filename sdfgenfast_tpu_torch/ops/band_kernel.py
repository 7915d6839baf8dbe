"""Narrow-band tile evaluation over CSR candidate segments (kernel K2).

Counterpart of ``sdfgenfast_tpu/ops/band_pallas.py``. For every active 8^3
tile, each cell takes the exact squared distance to every candidate triangle
of the tile's CSR segment (plane distance for barycentric-inside cells,
cancellation-free clamped-edge differences otherwise, the same evaluation as
``cpu_lib/makelevelset3.cpp:21-70``), keeps the LOWEST candidate id among
ties (segments are ascending, so a strict '<' walk is first-wins), and emits
phi, the winner id and its closest point p - dd.

Every affine-in-p quantity (plane distance, barycentric weights, edge
parameters) comes from a per-triangle (M, 40) coefficient table
(:func:`_band_coefs`), and each is evaluated as its row half plus its lane
half, ``(cx*x + (cy*y + c0)) + cz*z``, so that a CUDA thread computes the
row half once for the eight cells of its row.

Sharded blocks (``parallel/sharded.py``) pass coordinate ids: rows are
indexed by the block's local tile ids, cell positions come from the global
tile ids on the global tile grid, and ``upper`` from the global grid, so
every cell equals the single-device run's bit for bit.

``band_rows`` launches two CUDA kernels (``csrc/band_rows.cu``) for CUDA
tensors, the coefficient pass (:func:`band_coefs`) and the tile walk, and
runs ``band_rows_reference``, its plain-torch twin, for CPU tensors.
``band_coefs.launches`` and ``band_rows.launches`` count kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .vdt import FAR, sqrt_f32

__all__ = ["band_coefs", "band_csr_from_binning", "band_rows",
           "band_rows_reference", "CHUNK"]

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


def _dot(x1, x2):
    return x1[:, 0] * x2[:, 0] + x1[:, 1] * x2[:, 1] + x1[:, 2] * x2[:, 2]


def _band_coefs(tri9):
    """(M, 9) float32 grid-local vertices -> the (M, 40) coefficient table,
    rows of ten 4-word groups (``csrc/band_rows.cu`` reads them as float4):

      0: unit normal n, plane offset h0;  1: g23, g23c;  2: g31, g31c (the
      barycentric weights w23, w31 as affine forms); 3-5: the edge
      parameters of ab, ac, bc as [e, e0] (s = e.p + e0 along w = x1 - x2
      from x2); 6-8: the edge vectors w_ab, w_ac, w_bc, then b; 9: c and the
      degenerate flag (cross product squared <= 1e-30).

    The arithmetic of ``band_coefs_kernel``, operation for operation."""
    a, b, c = tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9]

    def edge(x1, x2):
        w = x1 - x2
        inv = torch.reciprocal(torch.clamp(_dot(w, w), min=1e-30))
        return w, torch.cat([w * inv[:, None], (-_dot(x2, w) * inv)[:, None]],
                            dim=1)

    w_ab, e_ab = edge(a, b)
    w_ac, e_ac = edge(a, c)
    w_bc, e_bc = edge(b, c)
    x13, x23 = a - c, b - c
    m13, m23, d = _dot(x13, x13), _dot(x23, x23), _dot(x13, x23)
    invdet = torch.reciprocal(torch.clamp(m13 * m23 - d * d, min=1e-30))
    g23 = invdet[:, None] * (m23[:, None] * x13 - d[:, None] * x23)
    g31 = invdet[:, None] * (m13[:, None] * x23 - d[:, None] * x13)
    cr = torch.stack([x13[:, 1] * x23[:, 2] - x13[:, 2] * x23[:, 1],
                      x13[:, 2] * x23[:, 0] - x13[:, 0] * x23[:, 2],
                      x13[:, 0] * x23[:, 1] - x13[:, 1] * x23[:, 0]], dim=1)
    cr2 = _dot(cr, cr)
    # 1 / sqrt, each correctly rounded (an rsqrt rounds differently on the
    # CPU and the card); the divisor is a tensor, never a Python scalar
    root = sqrt_f32(torch.clamp(cr2, min=1e-37))
    n = cr * (torch.ones_like(root) / root)[:, None]
    degen = (cr2 <= 1e-30).to(torch.float32)
    return torch.cat([
        n, -_dot(n, c)[:, None], g23, -_dot(g23, c)[:, None],
        g31, -_dot(g31, c)[:, None], e_ab, e_ac, e_bc,
        w_ab, w_ac, w_bc, b, c, degen[:, None]], dim=1).contiguous()


def _affine(cf, col, x, y, z):
    """cf[col] * x + (cf[col + 1] * y + cf[col + 3]) + cf[col + 2] * z: the
    row half, then the lane half."""
    return (cf[:, col] * x + (cf[:, col + 1] * y + cf[:, col + 3])
            + cf[:, col + 2] * z)


def _band_cell(cf, x, y, z):
    """The distance terms of rows `cf` ((A, 40) or (A, 40, 1)...) at cells
    (x, y, z): (d2, winner's p - cp as (ddx, ddy, ddz)), evaluated as
    ``band_rows_kernel`` does, the inside/edge choice included."""
    h = _affine(cf, 0, x, y, z)
    w23 = _affine(cf, 4, x, y, z)
    w31 = _affine(cf, 8, x, y, z)
    w12 = 1.0 - w23 - w31
    inside = ((torch.minimum(torch.minimum(w23, w31), w12) >= 0.0)
              & (cf[:, 39] == 0.0))

    def edge(e_col, w_cols, u):
        s = torch.clamp(_affine(cf, e_col, x, y, z), 0.0, 1.0)
        dd = [ui - s * cf[:, wc] for ui, wc in zip(u, w_cols)]
        return dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2], dd

    ub = (x - cf[:, 33], y - cf[:, 34], z - cf[:, 35])
    uc = (x - cf[:, 36], y - cf[:, 37], z - cf[:, 38])
    dab, dd_ab = edge(12, (24, 25, 26), ub)
    dac, dd_ac = edge(16, (27, 28, 29), uc)
    dbc, dd_bc = edge(20, (30, 31, 32), uc)
    d2 = torch.where(inside, h * h,
                     torch.minimum(dab, torch.minimum(dac, dbc)))
    ab_best = (dab <= dac) & (dab <= dbc)
    ac_best = ~ab_best & (dac <= dbc)
    dd = tuple(torch.where(inside, h * cf[:, i],
                           torch.where(ab_best, dd_ab[i],
                                       torch.where(ac_best, dd_ac[i],
                                                   dd_bc[i])))
               for i in range(3))
    return d2, dd


def _tile_cells(ids, tiles_dim, dx, device):
    """(A, 512) cell positions of the tiles `ids`, cell c = i*64 + j*8 + k."""
    _, ntj, ntk = tiles_dim
    t = ids.to(torch.int64)
    c = torch.arange(TILE_CELLS, device=device)
    x = ((t // (ntk * ntj))[:, None] * 8 + c // 64).to(torch.float32) * dx
    y = (((t // ntk) % ntj)[:, None] * 8 + (c // 8) % 8).to(torch.float32) * dx
    z = ((t % ntk)[:, None] * 8 + c % 8).to(torch.float32) * dx
    return x, y, z


def _coords(ids, tiles_dim, grid_shape, coord_ids, coord_tiles_dim,
            coord_grid_shape):
    """The coordinate stream: (ids, tiles_dim, grid_shape) by default."""
    given = (coord_ids, coord_tiles_dim, coord_grid_shape)
    if all(v is None for v in given):
        return ids, tuple(tiles_dim), tuple(grid_shape)
    if any(v is None for v in given):
        raise ValueError("give all of coord_ids, coord_tiles_dim, "
                         "coord_grid_shape or none")
    if coord_ids.dtype != torch.int32 or coord_ids.shape != ids.shape:
        raise ValueError(f"coord_ids must be int32 {tuple(ids.shape)}, got "
                         f"{tuple(coord_ids.shape)} {coord_ids.dtype}")
    if coord_ids.device != ids.device:
        raise ValueError(f"coord_ids is on {coord_ids.device}, ids on "
                         f"{ids.device}")
    return (coord_ids, tuple(int(v) for v in coord_tiles_dim),
            tuple(int(v) for v in coord_grid_shape))


def band_rows_reference(tri9, pair, ids, off, cnt, dx: float, *, tiles_dim,
                        grid_shape, coord_ids=None, coord_tiles_dim=None,
                        coord_grid_shape=None):
    """Plain-torch twin of :func:`band_rows`: the k-th candidate of every
    tile segment is evaluated for all 512 cells at once, k = 0, 1, ..., and
    merged with a strict '<', its closest point tracked with it — the
    kernel's walk, vectorized over tiles."""
    cids, ctd, cgs = _coords(ids, tiles_dim, grid_shape, coord_ids,
                             coord_tiles_dim, coord_grid_shape)
    dev = tri9.device
    M = tri9.shape[0]
    T = int(np.prod(tiles_dim))
    upper = _upper(cgs, dx)
    rows = _filled_rows(T, upper, dev)
    # padded slots (local id T) are skipped; their coordinates never read
    keep = ids < T
    ids, off, cnt, cids = ids[keep], off[keep], cnt[keep], cids[keep]
    A = ids.shape[0]
    if A == 0:
        return rows
    x, y, z = _tile_cells(cids, ctd, dx, dev)
    best = torch.full((A, TILE_CELLS), float("inf"), device=dev)
    best_t = torch.full((A, TILE_CELLS), -1, dtype=torch.int32, device=dev)
    bd = [torch.zeros((A, TILE_CELLS), device=dev) for _ in range(3)]

    off64 = off.to(torch.int64)
    cnt64 = cnt.to(torch.int64)
    table = torch.cat([_band_coefs(tri9),
                       torch.zeros((1, 40), dtype=tri9.dtype, device=dev)])
    P = pair.shape[0]
    for k in range(int(cnt.max()) if P else 0):
        cid = pair[(off64 + k).clamp(max=P - 1)].to(torch.int64)
        live = (k < cnt64) & (cid >= 0) & (cid < M)
        cf = table[torch.where(live, cid, M)][:, :, None]  # (A, 40, 1)
        d2, dd = _band_cell(cf, x, y, z)
        better = live[:, None] & (d2 < best)
        best = torch.where(better, d2, best)
        best_t = torch.where(better, cid.to(torch.int32)[:, None], best_t)
        bd = [torch.where(better, d, b) for d, b in zip(dd, bd)]
    has = best < float(upper * upper)
    t = ids.to(torch.int64)
    rows[0][t] = torch.where(has, sqrt_f32(best), float(upper))
    rows[1][t] = torch.where(has, best_t, -1)
    for r, p, d in zip(rows[2:], (x, y, z), bd):
        r[t] = torch.where(has, p - d, float(FAR))
    return rows


@build.counted
def band_coefs(tri9):
    """(M, 9) float32 grid-local vertices -> the (M, 40) table of
    :func:`_band_coefs`. CUDA: one launch of the coefficient pass. CPU:
    :func:`_band_coefs`."""
    if tri9.dtype != torch.float32 or tri9.dim() != 2 or tri9.shape[1] != 9:
        raise ValueError(f"tri9 must be (M, 9) float32, got "
                         f"{tuple(tri9.shape)} {tri9.dtype}")
    if tri9.device.type == "cpu":
        return _band_coefs(tri9)
    if tri9.device.type != "cuda":
        raise ValueError(f"band_coefs: unsupported device {tri9.device}")
    tri9 = tri9.contiguous()
    coef = torch.empty((tri9.shape[0], 40), dtype=torch.float32,
                       device=tri9.device)
    with torch.cuda.device(tri9.device):
        build.check(build.library().sdf_band_coefs(
            tri9.data_ptr(), tri9.shape[0], coef.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "sdf_band_coefs")
    band_coefs.launches += 1
    return coef


def _launch_rows(rows, coef, pair, ids, off, cnt, dx, tiles_dim, cids,
                 coord_tiles_dim, coord_grid_shape):
    """One launch of the tile walk into `rows` (the kernel writes every
    active tile's row whole), counted in ``band_rows.launches``."""
    with torch.cuda.device(coef.device):
        build.check(build.library().sdf_band_rows(
            coef.data_ptr(), coef.shape[0], pair.data_ptr(), ids.data_ptr(),
            cids.data_ptr(), off.data_ptr(), cnt.data_ptr(), ids.shape[0],
            int(np.prod(tiles_dim)), coord_tiles_dim[1], coord_tiles_dim[2],
            int(sum(coord_grid_shape)), float(dx),
            *(r.data_ptr() for r in rows),
            torch.cuda.current_stream().cuda_stream), "sdf_band_rows")
    band_rows.launches += 1


@build.counted
def band_rows(tri9, pair, ids, off, cnt, dx: float, *, tiles_dim, grid_shape,
              coord_ids=None, coord_tiles_dim=None, coord_grid_shape=None):
    """(T+1, 512) rows of (phi f32, tid int32, cpx, cpy, cpz f32).

    tri9: (M, 9) float32 GRID-LOCAL triangle vertices (origin subtracted);
    pair: (P,) int32 CSR candidate ids (ids >= M are padding); ids: (A,)
    int32 linear tile ids of the (T-tile) `tiles_dim` grid, T for padded
    slots, which are skipped; off/cnt: (A,) int32 segment starts and
    lengths. Rows of tiles that are not active hold the no-candidate values
    (upper, -1, FAR); row T is junk.

    A shard's block gives all three coord arguments (as
    ``band_pallas.band_rows_pallas``): coord_ids (A,) int32, each slot's
    tile id in the global `coord_tiles_dim` grid of the global
    `coord_grid_shape`, whose cells give the positions and whose
    f32(ni + nj + nk) * dx gives `upper`; rows stay indexed by `ids`.
    CUDA: the coefficient pass and one K2 launch. CPU:
    :func:`band_rows_reference`.
    """
    _check_args(tri9, pair, ids, off, cnt)
    kw = dict(coord_ids=coord_ids, coord_tiles_dim=coord_tiles_dim,
              coord_grid_shape=coord_grid_shape)
    if tri9.device.type == "cpu":
        return band_rows_reference(tri9, pair, ids, off, cnt, dx,
                                   tiles_dim=tiles_dim, grid_shape=grid_shape,
                                   **kw)
    if tri9.device.type != "cuda":
        raise ValueError(f"band_rows: unsupported device {tri9.device}")
    cids, ctd, cgs = _coords(ids, tiles_dim, grid_shape, **kw)
    pair, ids, off, cnt, cids = (a.contiguous()
                                 for a in (pair, ids, off, cnt, cids))
    T = int(np.prod(tiles_dim))
    rows = _filled_rows(T, _upper(cgs, dx), tri9.device)
    coef = band_coefs(tri9)
    _launch_rows(rows, coef, pair, ids, off, cnt, dx, tiles_dim, cids, ctd,
                 cgs)
    return rows
