"""Signed distance of points to a closed triangle mesh, by brute force.

The unsigned distance is the least point-triangle distance over every
triangle (the closest point by Ericson's region test, *Real-Time Collision
Detection* 5.1.5). The sign is the generalized winding number (the sum of
the triangles' solid angles by Van Oosterom and Strackee over 4 pi): inside
where it exceeds one half. Everything runs in the dtype asked for, in
blocks of points against all triangles, on the points' device.
"""

from __future__ import annotations

import math

import torch

PAIRS_PER_BLOCK = 1 << 22


def triangles(verts: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) corner coordinates."""
    return verts[tris.long()]


def _split(t):
    return t[..., 0], t[..., 1], t[..., 2]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _axpy(a, s, b):
    return (a[0] + s * b[0], a[1] + s * b[1], a[2] + s * b[2])


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def dist2(p, a, b, c):
    """Squared distance from points `p` to triangles (a, b, c), each a
    3-tuple of broadcastable component tensors; the closest point by
    Ericson's regions (vertex, edge or face), the first region that holds
    winning, as in his ClosestPtPointTriangle."""
    ab, ac, ap = _sub(b, a), _sub(c, a), _sub(p, a)
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = _sub(p, b)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = _sub(p, c)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    one = torch.ones((), dtype=va.dtype, device=va.device)

    def ratio(num, den):
        return num / torch.where(den == 0, one, den)

    denom = va + vb + vc
    q = _axpy(_axpy(a, ratio(vb, denom), ab), ratio(vc, denom), ac)
    bc_num, bc_den = d4 - d3, (d4 - d3) + (d5 - d6)
    q = _where((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
               _axpy(b, ratio(bc_num, bc_den), _sub(c, b)), q)
    q = _where((vb <= 0) & (d2 >= 0) & (d6 <= 0),
               _axpy(a, ratio(d2, d2 - d6), ac), q)
    q = _where((d6 >= 0) & (d5 <= d6), tuple(x.expand_as(q[0]) for x in c),
               q)
    q = _where((vc <= 0) & (d1 >= 0) & (d3 <= 0),
               _axpy(a, ratio(d1, d1 - d3), ab), q)
    q = _where((d3 >= 0) & (d4 <= d3), tuple(x.expand_as(q[0]) for x in b),
               q)
    q = _where((d1 <= 0) & (d2 <= 0), tuple(x.expand_as(q[0]) for x in a),
               q)
    e = _sub(p, q)
    return _dot(e, e)


def solid_angle(p, a, b, c):
    """The signed solid angle of triangles (a, b, c) seen from `p` (Van
    Oosterom and Strackee): positive where the triangle winds counter-
    clockwise seen from `p`, i.e. from inside an outward-oriented mesh."""
    x, y, z = _sub(a, p), _sub(b, p), _sub(c, p)
    lx = torch.sqrt(_dot(x, x))
    ly = torch.sqrt(_dot(y, y))
    lz = torch.sqrt(_dot(z, z))
    cross = (y[1] * z[2] - y[2] * z[1], y[2] * z[0] - y[0] * z[2],
             y[0] * z[1] - y[1] * z[0])
    det = _dot(x, cross)
    den = (lx * ly * lz + _dot(x, y) * lz + _dot(x, z) * ly
           + _dot(y, z) * lx)
    return 2.0 * torch.atan2(det, den)


def _blocks(n_points: int, n_tris: int):
    step = max(1, PAIRS_PER_BLOCK // max(n_tris, 1))
    for lo in range(0, n_points, step):
        yield lo, min(n_points, lo + step)


def closest(points: torch.Tensor, tri: torch.Tensor):
    """(d2 (S,), index (S,) int64): the squared distance of each point to
    its closest triangle of `tri` (M, 3, 3), in their dtype. Ties go to the
    lowest index."""
    a, b, c = (_split(tri[None, :, k]) for k in range(3))
    d2s, idx = [], []
    for lo, hi in _blocks(len(points), len(tri)):
        p = _split(points[lo:hi, None, :])
        v, i = torch.min(dist2(p, a, b, c), dim=1)
        d2s.append(v)
        idx.append(i)
    return torch.cat(d2s), torch.cat(idx)


def winding(points: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """(S,) the generalized winding number of each point, in their dtype."""
    a, b, c = (_split(tri[None, :, k]) for k in range(3))
    out = []
    for lo, hi in _blocks(len(points), len(tri)):
        p = _split(points[lo:hi, None, :])
        out.append(solid_angle(p, a, b, c).sum(dim=1))
    return torch.cat(out) / (4.0 * math.pi)


def signed_distance(points: torch.Tensor, tri: torch.Tensor):
    """(phi (S,), closest index (S,)): negative inside."""
    d2, idx = closest(points, tri)
    inside = winding(points, tri) > 0.5
    d = torch.sqrt(d2)
    return torch.where(inside, -d, d), idx


def distance_to(points: torch.Tensor, tri_sel: torch.Tensor) -> torch.Tensor:
    """(S,) the distance of each point to its own triangle `tri_sel` (S, 3,
    3); differentiable in `tri_sel` (the square root's argument held at
    1e-30 or more, so that a point on its triangle has a finite
    gradient)."""
    a, b, c = (_split(tri_sel[:, k]) for k in range(3))
    return torch.sqrt(torch.clamp(dist2(_split(points), a, b, c), min=1e-30))


def grid_points(origin, dx: float, shape, flat_index: torch.Tensor,
                dtype=torch.float64) -> torch.Tensor:
    """(S, 3) the positions origin + (i, j, k) dx of the cells of
    `flat_index` (C order over `shape`), computed in `dtype` from the
    float32 origin and dx the grid states."""
    ni, nj, nk = shape
    f = flat_index.long()
    ijk = torch.stack([f // (nj * nk), (f // nk) % nj, f % nk], dim=1)
    o = torch.tensor([float(v) for v in origin], dtype=dtype,
                     device=flat_index.device)
    return o + ijk.to(dtype) * float(dx)
