"""Dense all-triangles distance field: kernel K1.

Counterpart of ``sdfgenfast_tpu/ops/dense.py``. For meshes with few
triangles (the reference's benchmark box has 36) every cell is evaluated
against every triangle: the exact unsigned distance and the lowest-id
closest triangle of every cell, with no band binning and no far-field
propagation.

One kernel, :func:`dense_stream`, serves every table of up to
``DENSE_MAX_TRIS`` triangles. It evaluates the separable formulation: every
affine-in-p quantity of the point-triangle distance (plane distance,
barycentric weights, edge parameters) comes from a per-triangle (40, M)
coefficient table (:func:`_sep_coefs`), grouped exactly as the Pallas
kernel groups its row and lane halves. A table of one 128-triangle chunk
stays resident in shared memory; a larger one streams through it. Each
thread owns four consecutive k cells that share the row halves, and a
plane-bound cull, started from each warp's nearest triangle, skips the
triangles that cannot win. The JAX package takes its per-triangle
``_dense_kernel`` above 384 triangles, because its table did not fit the
TPU's SMEM; the two agree to rtol 2e-6 / atol 1e-6, ids to ties of the
float64 distance.

The walk merges triangles in ascending id order with a strict ``<``, so
ties keep the lowest id (cpu_lib/makelevelset3.cpp:215-218). Coordinates
are grid-local: the origin is subtracted from the triangles once, and cell
(i, j, k) sits at ``f32(i + offset) * dx``.

The wrapper launches the CUDA kernel (``csrc/dense.cu``) for a CUDA tensor
and runs the plain-torch twin :func:`dense_sep_reference` (the cull-free
walk of the same arithmetic) for a CPU tensor. ``dense_stream.launches``
counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .vdt import sqrt_f32

__all__ = ["DENSE_MAX_TRIS", "dense_distance_field", "dense_sep_reference",
           "dense_stream"]

# The JAX package's gate: above DENSE_MAX_TRIS the binned path wins (dense
# cost grows as cells x triangles).
DENSE_MAX_TRIS = 1024
_NC = 40  # rows of the separable coefficient table


def _dot(u, v):
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


def _sep_coefs(tri_verts):
    """(M, 3, 3) float32 -> (40, M) float32 per-triangle coefficient table,
    the row layout of ``sdfgenfast_tpu.ops.dense._sep_coefs``:

      0:3 b, 3:6 c, 6:15 the edge vectors a-b, a-c, b-c, 15:27 the three
      edge parameters s = e.p + e0 as [ex, ey, ez, e0], 27:31 the unit
      normal and plane offset, 31:39 the barycentric weights w23 and w31 as
      affine forms, 39 the degenerate flag (cross product squared <= 1e-30).
    """
    a = tri_verts[:, 0, :]
    b = tri_verts[:, 1, :]
    c = tri_verts[:, 2, :]

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

    return torch.cat([
        b.T, c.T,
        w_ab.T, w_ac.T, w_bc.T,
        e_ab.T, e0_ab[None], e_ac.T, e0_ac[None], e_bc.T, e0_bc[None],
        n.T, h0[None],
        g23.T, g23c[None], g31.T, g31c[None],
        degen[None],
    ], dim=0)


def _cell_axes(grid_shape, dx: float, ijk_offset, device):
    """Cell coordinates f32(index + offset) * dx as (ni,1,1), (1,nj,1) and
    (1,1,nk) tensors."""
    axes = []
    for ax, (n, off) in enumerate(zip(grid_shape, ijk_offset)):
        shape = [1, 1, 1]
        shape[ax] = n
        idx = torch.arange(off, off + n, device=device)
        axes.append((idx.to(torch.float32) * dx).reshape(shape))
    return tuple(axes)


def _merge(best, best_t, d2, t):
    better = d2 < best
    return torch.where(better, d2, best), torch.where(better, t, best_t)


def _init(grid_shape, device):
    return (torch.full(grid_shape, float("inf"), dtype=torch.float32,
                       device=device),
            torch.full(grid_shape, -1, dtype=torch.int32, device=device))


def dense_sep_reference(coef, dx: float, *, grid_shape, ijk_offset=(0, 0, 0)):
    """Plain-torch twin of :func:`dense_stream`: the same per-triangle
    arithmetic over the whole grid, one triangle at a time, without the
    cull (the cull never changes a result in exact arithmetic)."""
    x, y, z = _cell_axes(grid_shape, dx, ijk_offset, coef.device)
    best, best_t = _init(grid_shape, coef.device)

    def edge_d2(su, sv, wx, wy, wz, ux, uy, uz):
        s = torch.clamp(su + sv, 0.0, 1.0)
        ddx = ux - s * wx
        ddy = uy - s * wy
        ddz = uz - s * wz
        return ddx * ddx + ddy * ddy + ddz * ddz

    for t in range(coef.shape[1]):
        cf = coef[:, t]
        h = (cf[27] * x + (cf[28] * y + cf[30])) + cf[29] * z
        din = h * h
        w23u = cf[31] * x + (cf[32] * y + cf[34])
        w23v = cf[33] * z
        w31u = cf[35] * x + (cf[36] * y + cf[38])
        w31v = cf[37] * z
        w12u = 1.0 - w23u - w31u
        w12v = -(w23v + w31v)
        inside = (torch.minimum(torch.minimum(w23u + w23v, w31u + w31v),
                                w12u + w12v) >= 0.0) & (cf[39] < 0.5)
        ubx, uby, ubz = x - cf[0], y - cf[1], z - cf[2]
        ucx, ucy, ucz = x - cf[3], y - cf[4], z - cf[5]
        d_ab = edge_d2(cf[15] * x + (cf[16] * y + cf[18]), cf[17] * z,
                       cf[6], cf[7], cf[8], ubx, uby, ubz)
        d_ac = edge_d2(cf[19] * x + (cf[20] * y + cf[22]), cf[21] * z,
                       cf[9], cf[10], cf[11], ucx, ucy, ucz)
        d_bc = edge_d2(cf[23] * x + (cf[24] * y + cf[26]), cf[25] * z,
                       cf[12], cf[13], cf[14], ucx, ucy, ucz)
        d2 = torch.where(inside, din,
                         torch.minimum(d_ab, torch.minimum(d_ac, d_bc)))
        best, best_t = _merge(best, best_t, d2, t)
    return sqrt_f32(best), best_t


def dense_stream(coef, dx: float, *, grid_shape, ijk_offset=(0, 0, 0)):
    """(phi, tid) over the whole grid from the (40, M) table of
    :func:`_sep_coefs`. CUDA: one K1 launch. CPU: :func:`dense_sep_reference`."""
    if coef.dtype != torch.float32 or coef.dim() != 2 or coef.shape[0] != _NC:
        raise ValueError(f"dense_stream: table must be ({_NC}, M) float32, "
                         f"got {tuple(coef.shape)} {coef.dtype}")
    if coef.device.type == "cpu":
        return dense_sep_reference(coef, dx, grid_shape=grid_shape,
                                   ijk_offset=ijk_offset)
    if coef.device.type != "cuda":
        raise ValueError(f"dense_stream: unsupported device {coef.device}")
    coef = coef.contiguous()
    phi = torch.empty(grid_shape, dtype=torch.float32, device=coef.device)
    tid = torch.empty(grid_shape, dtype=torch.int32, device=coef.device)
    lib = build.library()
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.sdf_dense_stream(
            coef.data_ptr(), coef.shape[1], *grid_shape, *ijk_offset,
            float(dx), phi.data_ptr(), tid.data_ptr(), stream),
            "sdf_dense_stream")
    dense_stream.launches += 1
    return phi, tid


dense_stream.launches = 0


def dense_distance_field(tri_verts, origin, dx, *, grid_shape, ijk_offset=None):
    """Exact min distance and lowest-id closest triangle of every cell.

    tri_verts: (M, 3, 3) float32 tensor; origin: (3,) (tensor or sequence);
    dx: a float32-representable scalar; ijk_offset: optional (3,) integer
    shift of the cell indices (cells use global indices). Returns (phi, tid):
    (ni, nj, nk) float32 unsigned distances and int32 ids, on the device of
    tri_verts. One K1 launch for M <= 1024, ValueError above.
    """
    if (tri_verts.dtype != torch.float32 or tri_verts.dim() != 3
            or tuple(tri_verts.shape[1:]) != (3, 3)):
        raise ValueError(f"tri_verts must be (M, 3, 3) float32, got "
                         f"{tuple(tri_verts.shape)} {tri_verts.dtype}")
    m = int(tri_verts.shape[0])
    if m > DENSE_MAX_TRIS:
        raise ValueError(
            f"dense path capped at {DENSE_MAX_TRIS} triangles, got {m}")
    grid_shape = tuple(int(n) for n in grid_shape)
    off = (0, 0, 0) if ijk_offset is None else tuple(int(v) for v in ijk_offset)
    dx = float(np.float32(float(dx)))
    origin = torch.as_tensor(origin, dtype=torch.float32,
                             device=tri_verts.device)
    # grid-local coordinates: coefficients stay O(mesh extent), not
    # O(|origin|), for meshes far from the world origin
    tri_local = tri_verts - origin
    kw = dict(grid_shape=grid_shape, ijk_offset=off)
    return dense_stream(_sep_coefs(tri_local).contiguous(), dx, **kw)
