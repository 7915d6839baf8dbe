"""Per-tile candidate evaluation for any band tile shape, in plain torch.

Counterpart of ``sdfgenfast_tpu/ops/tiled.py`` (the pre-materialised
``tbl`` blocks are not ported). A shard's block passes ``ijk_offset``, the
global index of its cell (0, 0, 0), and ``upper_override``, the global
grid's upper bound. The band of every tile shape other than
8^3 comes from here; 8^3 tiles take kernel K2 (``ops/band_kernel.py``),
which computes the same function.

Reference semantics: the exact point->triangle distance with the case
analysis and clamping of ``cpu_lib/makelevelset3.cpp:21-70``, the minimum
over the tile's candidate list, the lowest id among ties. Every quantity
that is affine in the cell position p (plane distance h, barycentric
weights w23 and w31, the three edge parameters s) comes from a per-triangle
(M+1, 40) table (:func:`tri_affine_table`) as ``e . p + e0``. The JAX
package evaluates the six forms of a tile chunk as one (C, 4) @ (4, 6K)
product at ``Precision.HIGHEST``; here each is four products summed in a
fixed order, ``((ex*x + ey*y) + ez*z) + e0``, so that the CPU and the card
evaluate one expression (no matrix product, so no TF32). Edge distances
keep the cancellation-free difference form ``dd = (p - x2) - s*(x1 - x2)``.

Device: the tensors' own (CUDA or CPU); the same torch code on both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .band_kernel import _upper
from .geometry import _dot
from .vdt import FAR, sqrt_f32

__all__ = ["tri_affine_table", "tile_candidate_rows", "scatter_rows",
           "scatter_untile", "tile_candidate_field", "closest_point_rows",
           "untile_rows"]

_NT = 40  # columns per triangle in the affine table
_INT_BIG = 2**31 - 1


def tri_affine_table(tri_local):
    """(M, 3, 3) float32 GRID-LOCAL vertices -> (M+1, 40) float32 table.

    Columns (p is the grid-local cell position):
      0:3 n, 3 h0          unit normal, h = n.p + h0 the signed plane distance
      4:7 g23, 7 g23c      w23 = g23.p + g23c, the weight on vertex a
      8:11 g31, 11 g31c    w31, the weight on vertex b
      12:16, 16:20, 20:24  the edges ab, ac, bc: s = e.p + e0
      24:27 b, 27:30 c     x2 of edge ab; x2 of edges ac and bc
      30:33, 33:36, 36:39  w_ab = a - b, w_ac = a - c, w_bc = b - c
      39                   degenerate flag (|(a - c) x (b - c)|^2 <= 1e-30)

    Row M is the sentinel of invalid candidate slots: degenerate, with b
    and c at 3e18, so it never wins."""
    a = tri_local[:, 0, :]
    b = tri_local[:, 1, :]
    c = tri_local[:, 2, :]

    def edge(x1, x2):
        w = x1 - x2
        inv = 1.0 / torch.clamp(_dot(w, w), min=1e-30)
        return w, w * inv[:, None], -_dot(x2, w) * inv

    w_ab, e_ab, e0_ab = edge(a, b)
    w_ac, e_ac, e0_ac = edge(a, c)
    w_bc, e_bc, e0_bc = edge(b, c)

    x13 = a - c
    x23 = b - c
    m13 = _dot(x13, x13)
    m23 = _dot(x23, x23)
    d = _dot(x13, x23)
    invdet = 1.0 / torch.clamp(m13 * m23 - d * d, min=1e-30)
    g23 = invdet[:, None] * (m23[:, None] * x13 - d[:, None] * x23)
    g23c = -_dot(g23, c)
    g31 = invdet[:, None] * (m13[:, None] * x23 - d[:, None] * x13)
    g31c = -_dot(g31, c)

    cr = torch.stack([x13[:, 1] * x23[:, 2] - x13[:, 2] * x23[:, 1],
                      x13[:, 2] * x23[:, 0] - x13[:, 0] * x23[:, 2],
                      x13[:, 0] * x23[:, 1] - x13[:, 1] * x23[:, 0]], dim=1)
    cr2 = _dot(cr, cr)
    n = cr / sqrt_f32(torch.clamp(cr2, min=1e-37))[:, None]
    h0 = -_dot(n, c)
    degen = (cr2 <= 1e-30).to(torch.float32)

    tbl = torch.cat([
        n, h0[:, None], g23, g23c[:, None], g31, g31c[:, None],
        e_ab, e0_ab[:, None], e_ac, e0_ac[:, None], e_bc, e0_bc[:, None],
        b, c, w_ab, w_ac, w_bc, degen[:, None]], dim=1)
    sentinel = torch.zeros((1, _NT), dtype=torch.float32,
                           device=tri_local.device)
    sentinel[0, 24:30] = float(FAR)
    sentinel[0, _NT - 1] = 1.0
    return torch.cat([tbl, sentinel], dim=0)


def _tile_local_offsets(tile_shape, device):
    """(C, 3) int64 (i, j, k) offsets of a tile's cells, k fastest."""
    ti, tj, tk = tile_shape
    grid = torch.meshgrid(*(torch.arange(n, device=device)
                            for n in (ti, tj, tk)), indexing="ij")
    return torch.stack(grid, dim=-1).reshape(-1, 3)


def _tile_cells(ids, tile_shape, tiles_dim, local, ijk_offset=None):
    """(B, C, 3) int64 cell indices of the tiles `ids`, shifted by
    `ijk_offset` ((i, j, k) ints; None = zeros)."""
    _, ntj, ntk = tiles_dim
    t = ids.to(torch.int64)
    base = torch.stack([t // (ntk * ntj), (t // ntk) % ntj, t % ntk], dim=-1)
    base = base * torch.tensor(tile_shape, device=ids.device)
    if ijk_offset is not None:
        base = base + torch.tensor([int(v) for v in ijk_offset],
                                   device=ids.device)
    return base[:, None, :] + local[None, :, :]


def _chunks(n: int, chunk: int):
    for s in range(0, n, chunk):
        yield s, min(s + chunk, n)


def _form(cf, col, x, y, z):
    """((cf[col]*x + cf[col+1]*y) + cf[col+2]*z) + cf[col+3]."""
    return ((cf[..., col] * x + cf[..., col + 1] * y)
            + cf[..., col + 2] * z) + cf[..., col + 3]


def tile_candidate_rows(tri_verts, active_ids, cand, cand_valid, origin,
                        dx: float, tile_shape: Tuple[int, int, int],
                        tiles_dim: Tuple[int, int, int],
                        grid_shape: Tuple[int, int, int], chunk: int = 128,
                        ijk_offset=None, upper_override=None):
    """(A, C) (phi, tid) rows of the active tiles: each cell's minimum over
    its tile's candidates (the lowest id among ties), ``upper`` and -1 where
    no candidate comes below ``upper``.

    tri_verts (M, 3, 3) float32 WORLD vertices; active_ids (A,) int32
    linear tile ids; cand / cand_valid (A, K) int32 / bool; origin (3,)
    float32 tensor; dx a float32-representable float. Cell positions are
    f32(i + ijk_offset) * dx in grid-local coordinates; ``upper`` is
    f32(ni + nj + nk) * dx of `grid_shape`, or `upper_override` (a shard's
    block passes the global grid's)."""
    device = tri_verts.device
    M = tri_verts.shape[0]
    A = active_ids.shape[0]
    C = int(np.prod(tile_shape))
    upper = (_upper(grid_shape, dx) if upper_override is None
             else np.float32(upper_override))
    if A == 0:
        return (torch.zeros((0, C), dtype=torch.float32, device=device),
                torch.zeros((0, C), dtype=torch.int32, device=device))
    table = tri_affine_table(tri_verts - origin)
    cand_idx = torch.where(cand_valid, cand, M).to(torch.int64)
    local = _tile_local_offsets(tile_shape, device)
    phi_rows, tid_rows = [], []
    for s, e in _chunks(A, chunk):
        cd = cand_idx[s:e]
        tbl = table[cd][:, None]  # (B, 1, K, 40): one row gather a pair
        p = _tile_cells(active_ids[s:e], tile_shape, tiles_dim, local,
                        ijk_offset).to(torch.float32) * dx  # (B, C, 3)
        x, y, z = (p[..., i, None] for i in range(3))  # (B, C, 1)

        h = _form(tbl, 0, x, y, z)
        w23 = _form(tbl, 4, x, y, z)
        w31 = _form(tbl, 8, x, y, z)
        w12 = 1.0 - w23 - w31
        inside = ((torch.minimum(torch.minimum(w23, w31), w12) >= 0.0)
                  & (tbl[..., 39] < 0.5))

        def edge_d2(e_col, x2_col, w_col):
            t = torch.clamp(_form(tbl, e_col, x, y, z), 0.0, 1.0)
            dd = [(u - tbl[..., x2_col + i]) - t * tbl[..., w_col + i]
                  for i, u in enumerate((x, y, z))]
            return dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]

        d_ab = edge_d2(12, 24, 30)
        d_ac = edge_d2(16, 27, 33)
        d_bc = edge_d2(20, 27, 36)
        d2 = torch.where(inside, h * h,
                         torch.minimum(d_ab, torch.minimum(d_ac, d_bc)))

        dmin2 = d2.min(dim=-1).values  # (B, C)
        # the lowest id among ties, without a trailing-axis gather
        tid = torch.where(d2 <= dmin2[..., None], cd[:, None, :],
                          _INT_BIG).min(dim=-1).values.to(torch.int32)
        has = dmin2 < float(upper * upper)
        phi_rows.append(torch.where(has, sqrt_f32(dmin2), float(upper)))
        tid_rows.append(torch.where(has, tid, -1))
    return torch.cat(phi_rows), torch.cat(tid_rows)


def untile_rows(rows, tile_shape, tiles_dim, grid_shape):
    """(T, C) tile rows -> dense (ni, nj, nk) grid (pure reshape+permute,
    no scatter — for kernels that emit rows for EVERY tile)."""
    ni, nj, nk = grid_shape
    nti, ntj, ntk = tiles_dim
    ti, tj, tk = tile_shape
    x = rows.reshape(nti, ntj, ntk, ti, tj, tk)
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(nti * ti, ntj * tj, ntk * tk)
    return x[:ni, :nj, :nk].contiguous()


def scatter_rows(rows, active_ids, fill, tile_shape, tiles_dim, grid_shape):
    """(A, C) rows -> one dense (ni, nj, nk) grid: each row into its tile,
    `fill` in tiles that no row names; rows whose id is the sentinel T (or
    beyond) are dropped."""
    T = int(np.prod(tiles_dim))
    C = int(np.prod(tile_shape))
    tiles = torch.full((T, C), fill, dtype=rows.dtype, device=rows.device)
    keep = active_ids < T
    tiles[active_ids[keep].to(torch.int64)] = rows[keep]
    return untile_rows(tiles, tile_shape, tiles_dim, grid_shape)


def scatter_untile(phi_rows, tid_rows, active_ids, upper, tile_shape,
                   tiles_dim, grid_shape):
    """(A, C) (phi, tid) rows -> dense grids (see :func:`scatter_rows`)."""
    return (scatter_rows(phi_rows, active_ids, float(upper), tile_shape,
                         tiles_dim, grid_shape),
            scatter_rows(tid_rows, active_ids, -1, tile_shape, tiles_dim,
                         grid_shape))


def tile_candidate_field(tri_verts, active_ids, cand, cand_valid, origin,
                         dx: float, tile_shape, tiles_dim, grid_shape,
                         chunk: int = 128):
    """Dense (ni, nj, nk) (phi, closest_tri): :func:`tile_candidate_rows`
    + :func:`scatter_untile`."""
    phi_rows, tid_rows = tile_candidate_rows(
        tri_verts, active_ids, cand, cand_valid, origin, dx, tile_shape,
        tiles_dim, grid_shape, chunk=chunk)
    return scatter_untile(phi_rows, tid_rows, active_ids,
                          _upper(grid_shape, dx), tile_shape, tiles_dim,
                          grid_shape)


def closest_point_rows(table, active_ids, tid_rows, dx: float, tile_shape,
                       tiles_dim, chunk: int = 128, ijk_offset=None):
    """Exact closest points of the band winners, the VDT seeds: (cpx, cpy,
    cpz) rows (A, C) in grid-local coordinates, FAR where tid < 0. Cells
    sit at f32(i + ijk_offset) * dx, as in :func:`tile_candidate_rows`.

    One table row gathered per cell (its winner's), then the case analysis
    of the distance (cpu_lib/makelevelset3.cpp:49-70): inside, p - h*n;
    otherwise the clamped projection x2 + s*(x1 - x2) onto the nearest
    edge (the first of ab, ac, bc at a tie)."""
    M = table.shape[0] - 1
    A = active_ids.shape[0]
    C = int(np.prod(tile_shape))
    if A == 0:
        e = torch.zeros((0, C), dtype=torch.float32, device=table.device)
        return e, e, e
    local = _tile_local_offsets(tile_shape, table.device)
    out = ([], [], [])
    for s, e in _chunks(A, chunk):
        tids = tid_rows[s:e]
        tbl = table[torch.where(tids >= 0, tids, M).to(torch.int64)]
        p = _tile_cells(active_ids[s:e], tile_shape, tiles_dim, local,
                        ijk_offset).to(torch.float32) * dx
        u = (p[..., 0], p[..., 1], p[..., 2])

        h = _form(tbl, 0, *u)
        w23 = _form(tbl, 4, *u)
        w31 = _form(tbl, 8, *u)
        w12 = 1.0 - w23 - w31
        inside = ((torch.minimum(torch.minimum(w23, w31), w12) >= 0.0)
                  & (tbl[..., 39] < 0.5))

        def edge(e_col, x2_col, w_col):
            t = torch.clamp(_form(tbl, e_col, *u), 0.0, 1.0)
            dd = [(ui - tbl[..., x2_col + i]) - t * tbl[..., w_col + i]
                  for i, ui in enumerate(u)]
            return (dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2],
                    [tbl[..., x2_col + i] + t * tbl[..., w_col + i]
                     for i in range(3)])

        d_ab, cp_ab = edge(12, 24, 30)
        d_ac, cp_ac = edge(16, 27, 33)
        d_bc, cp_bc = edge(20, 27, 36)
        ab_best = (d_ab <= d_ac) & (d_ab <= d_bc)
        ac_best = ~ab_best & (d_ac <= d_bc)
        valid = tids >= 0
        for i in range(3):
            cp_edge = torch.where(ab_best, cp_ab[i],
                                  torch.where(ac_best, cp_ac[i], cp_bc[i]))
            cp = torch.where(inside, u[i] - h * tbl[..., i], cp_edge)
            out[i].append(torch.where(valid, cp, float(FAR)))
    return tuple(torch.cat(o) for o in out)
