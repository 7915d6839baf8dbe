"""Hand-made inputs for checking the port's kernels against their twins,
and the torus's analytic oracle.

Used by the CPU tests (``tests/test_torch_*.py``) and by ``chip_smoke.py``
on the card, so both hold a kernel, and the torus's field, to the same
cases and bars. Nothing on the generation path imports this module."""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, box_mesh
from .ops.band_kernel import CHUNK
from .ops.geometry import point_triangle_distance_sq

__all__ = ["box36", "k2_segments", "torus_sdf", "tessellation_gap",
           "torus_bars", "check_torus_bars"]

# mesh.torus_mesh's radii
TORUS_R = 1.0
TORUS_r = 0.4


def box36():
    """The reference's 36-triangle benchmark box (``bench.py``): the 3x4x5
    box with each face triangle split 1->3 at its centroid."""
    m = box_mesh((3, 4, 5), (-1, -1, -1))
    cent = m.verts[m.tris].mean(axis=1).astype(np.float32)
    nv = len(m.verts)
    tris = [(a, b, nv + i) for i, (a0, b0, c0) in enumerate(m.tris)
            for a, b in ((a0, b0), (b0, c0), (c0, a0))]
    return Mesh(np.concatenate([m.verts, cent]), np.asarray(tris, np.uint32))


def k2_segments(tl, dx, tiles_dim, active, counts):
    """Hand-made K2 segments for (M, 3, 3) grid-local triangles `tl`: on
    distinct active tiles, the `counts[i]` triangles nearest tile
    active[i * len(active) // len(counts)], two zero-area ones added to the
    last (a point at the tile's centre and a segment from it, ids 0 and 1:
    the table is the zero-area rows, then `tl` as ids 2 .. M + 1, so they
    win the cells around the centre and the point wins the ties with the
    segment); the 40 triangles nearest the grid's far corner tile;
    each ascending, padded to a CHUNK multiple with the sentinel id M + 2;
    and a padded slot. Returns (tri9, pair, ids, off, cnt)."""
    T = int(np.prod(tiles_dim))
    _, ntj, ntk = tiles_dim
    M = len(tl)
    cen = tl.mean(axis=1)

    def centre(t):
        return (np.array([t // (ntj * ntk), (t // ntk) % ntj, t % ntk]) * 8
                + 3.5) * dx

    def nearest(t, n):
        d = np.linalg.norm(cen - centre(t), axis=1)
        return np.sort(np.argsort(d)[:n]) + 2

    picks = [int(active[i * len(active) // len(counts)])
             for i in range(len(counts))]
    segs = [(t, nearest(t, n)) for t, n in zip(picks, counts)]
    a = centre(picks[-1])
    b = a + np.array([2.0, 1.0, 0.0]) * dx
    zero = np.stack([np.stack([a, a, a]), np.stack([a, b, b])])
    segs[-1] = (picks[-1], np.concatenate([[0, 1], segs[-1][1]]))
    segs.append((T - 1, nearest(T - 1, 40)))
    if len({t for t, _ in segs}) != len(segs):
        raise AssertionError("hand-made K2 tiles are not distinct")
    pair, ids, off, cnt = [], [], [], []
    for t, c in segs:
        n = -(-len(c) // CHUNK) * CHUNK
        ids.append(t)
        off.append(len(pair))
        cnt.append(n)
        pair += list(c) + [M + 2] * (n - len(c))
    ids.append(T)  # a padded slot: no candidates, the junk row
    off.append(0)
    cnt.append(0)
    tri9 = np.concatenate([zero, tl]).astype(np.float32).reshape(-1, 9)
    return (tri9, *(np.asarray(a, np.int32) for a in (pair, ids, off, cnt)))


def torus_sdf(points, R: float = TORUS_R, r: float = TORUS_r):
    """The torus's signed distance, sqrt((sqrt(x^2 + y^2) - R)^2 + z^2) - r,
    negative inside, in float64 on the points' device. points: (..., 3)
    tensor (any float dtype)."""
    p = points.double()
    rho = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1])
    return torch.sqrt((rho - R) ** 2 + p[..., 2] * p[..., 2]) - r


def _lattice(order: int):
    """(L, 3) float64 barycentric weights (i, j, k) / order, i + j + k =
    order: the vertices, the edges' points at 1/order steps and, for an
    order divisible by 6, the edge midpoints and the centroid."""
    w = [(i, j, order - i - j) for i in range(order + 1)
         for j in range(order + 1 - i)]
    return torch.tensor(w, dtype=torch.float64) / order


def tessellation_gap(mesh: Mesh, R: float = TORUS_R, r: float = TORUS_r,
                     device="cpu") -> float:
    """A bound on the Hausdorff distance between a ``mesh.torus_mesh``
    torus and the analytic surface of radii (R, r), in float64: the larger
    of

    - the largest |torus_sdf| over a barycentric lattice of 28 points on
      every triangle (order 6: the vertices, the edge midpoints, the
      centroid), the mesh's distance to the surface;
    - over the (u, v) quads, the distance from the analytic surface point at
      the quad's parametric centre to the quad's two triangles (triangles t
      and t + M / 2 of torus_mesh's layout, t = [a, b, d] from corner a to
      the opposite corner d), the surface's distance to the mesh.

    Both are within the chord sagitta of the surface, (R + 2 r)(1 - cos
    (pi / n)) for n quads around each circle."""
    dev = torch.device(device)
    v = torch.as_tensor(mesh.verts, device=dev).double()
    t = torch.as_tensor(mesh.tris.astype(np.int64), device=dev)
    tv = v[t]  # (M, 3, 3)
    lat = _lattice(6).to(dev)
    on_mesh = float(torus_sdf(torch.einsum("lc,mcx->mlx", lat, tv),
                              R, r).abs().max())
    half = len(t) // 2
    a, d = tv[:half, 0], tv[:half, 2]

    def params(x):
        rho = torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1])
        return torch.atan2(x[:, 1], x[:, 0]), torch.atan2(x[:, 2], rho - R)

    def mid(p, q):
        return p + torch.remainder(q - p + np.pi, 2 * np.pi) / 2 - np.pi / 2

    (ua, va), (ud, vd) = params(a), params(d)
    u, w = mid(ua, ud), mid(va, vd)
    s = torch.stack([(R + r * torch.cos(w)) * torch.cos(u),
                     (R + r * torch.cos(w)) * torch.sin(u),
                     r * torch.sin(w)], dim=1)
    d2 = torch.minimum(
        point_triangle_distance_sq(s, tv[:half, 0], tv[:half, 1],
                                   tv[:half, 2]),
        point_triangle_distance_sq(s, tv[half:, 0], tv[half:, 1],
                                   tv[half:, 2]))
    return max(on_mesh, float(torch.sqrt(d2).max()))


def torus_bars(phi, grid, gap: float, exact=None, R: float = TORUS_R,
               r: float = TORUS_r) -> dict:
    """The torus's field `phi` ((ni, nj, nk) tensor on any device) against
    the analytic oracle s = torus_sdf(cell positions), the cell positions
    origin + (i, j, k) * dx in float64, and `gap`, the mesh's Hausdorff
    bound (:func:`tessellation_gap`). `exact`: a bool mask of the band
    cells the binning marks exact (None: none). Returns

    - ``sign_mismatches``: cells with |s| > gap + 1e-6 whose sign differs;
    - ``band_dev``: the largest | |phi| - |s| | on the exact cells;
    - ``below``: the largest |s| - gap - |phi| (never-below-exact);
    - ``excess_dx``: the largest (|phi| - |s| - gap) / dx on the cells in
      the hole (sqrt(x^2 + y^2) < R - r) and on the others ("outside").

    Evaluated 16 i-planes at a time, in float64 on phi's device."""
    dev = phi.device
    dx = float(np.float32(grid.dx))
    ax = [torch.as_tensor(grid.cell_positions_axis(a), device=dev)
          for a in range(3)]
    out = {"sign_mismatches": 0, "band_dev": 0.0, "below": -np.inf,
           "excess_dx": {"hole": -np.inf, "outside": -np.inf}}
    slab = 16
    for i0 in range(0, grid.shape[0], slab):
        x = ax[0][i0:i0 + slab, None, None]
        y, z = ax[1][None, :, None], ax[2][None, None, :]
        p = torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)
        s = torus_sdf(p, R, r)
        f = phi[i0:i0 + slab].double()
        off = s.abs() > gap + 1e-6
        out["sign_mismatches"] += int(((f < 0) != (s < 0))[off].sum())
        if exact is not None:
            e = exact[i0:i0 + slab]
            if bool(e.any()):
                out["band_dev"] = max(out["band_dev"], float(
                    (f.abs() - s.abs())[e].abs().max()))
        out["below"] = max(out["below"], float(
            (s.abs() - gap - f.abs()).max()))
        excess = (f.abs() - s.abs() - gap) / dx
        hole = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) < R - r
        for key, m in (("hole", hole), ("outside", ~hole)):
            if bool(m.any()):
                out["excess_dx"][key] = max(out["excess_dx"][key],
                                            float(excess[m].max()))
    return out


def check_torus_bars(label: str, bars: dict, gap: float, dx: float) -> None:
    """Raise unless :func:`torus_bars`'s readings meet the oracle's bars: 0
    sign mismatches off the surface's gap, the exact band within gap +
    1e-5, no cell below |s| - gap - 1e-5 and none above |s| + gap +
    0.2 * dx."""
    if bars["sign_mismatches"]:
        raise AssertionError(f"{label}: {bars['sign_mismatches']} sign "
                             f"mismatches against the analytic torus")
    if not bars["band_dev"] <= gap + 1e-5:
        raise AssertionError(f"{label}: exact band {bars['band_dev']:.3e} "
                             f"from the analytic torus (gap {gap:.3e})")
    if not bars["below"] <= 1e-5:
        raise AssertionError(f"{label}: a cell {bars['below']:.3e} below "
                             f"|s| - gap")
    worst = max(bars["excess_dx"].values())
    if not worst <= 0.2:
        raise AssertionError(f"{label}: far field {worst:.4f} dx above |s| + "
                             f"gap (hole {bars['excess_dx']['hole']:.4f}, "
                             f"outside {bars['excess_dx']['outside']:.4f})")
