"""Point-triangle distance, structure-of-arrays form, in PyTorch (float32).

Counterpart of ``point_triangle_distance_sq_soa`` and ``gather_tri9`` in
``sdfgenfast_tpu/ops/geometry.py``: the reference's case analysis and
clamping (``point_segment_distance`` / ``point_triangle_distance``,
cpu_lib/makelevelset3.cpp:21-70) as branchless tensor code. It is the
per-triangle body of the recompute kernel R1 (``csrc/recompute.cu``) and of
its plain twin, so the operation order is the JAX package's, step for step:
the CUDA kernel repeats it with ``--fmad=false``.

Under autograd it differentiates as the JAX function does: the clamps are
``maximum``/``minimum`` pairs (as ``jnp.clip`` and ``jnp.maximum`` are), so
a value exactly on a clamp bound passes half its gradient, where
``torch.clamp`` would pass all of it.
"""

from __future__ import annotations

import torch

__all__ = ["gather_tri9", "point_triangle_distance_sq_soa"]


def _d3(ux, uy, uz, vx, vy, vz):
    return ux * vx + uy * vy + uz * vz


def _at_least(x, lo: float):
    return torch.maximum(x, x.new_full((), lo))


def _clip01(x):
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def gather_tri9(tri9, tid):
    """Triangle vertex coordinates of every id in `tid` as nine 1-D gathers
    from the (9, M) table (rows ax, ay, az, bx, .., cz). Negative ids read
    triangle 0 (callers mask by ``tid >= 0``). Returns (a, b, c): three
    length-3 tuples of tensors shaped like `tid`."""
    flat = torch.clamp(tid, min=0).reshape(-1).long()
    vs = [tri9[r][flat].reshape(tid.shape) for r in range(9)]
    return tuple(vs[0:3]), tuple(vs[3:6]), tuple(vs[6:9])


def point_triangle_distance_sq_soa(p, a, b, c):
    """Squared distance from points p to triangles (a, b, c).

    p, a, b, c: length-3 tuples of float32 tensors that broadcast against
    each other. Returns the broadcast float32 tensor.
    """
    x13 = tuple(a[i] - c[i] for i in range(3))
    x23 = tuple(b[i] - c[i] for i in range(3))
    x03 = tuple(p[i] - c[i] for i in range(3))
    m13 = _d3(*x13, *x13)
    m23 = _d3(*x23, *x23)
    d = _d3(*x13, *x23)
    invdet = 1.0 / _at_least(m13 * m23 - d * d, 1e-30)
    pa = _d3(*x13, *x03)
    pb = _d3(*x23, *x03)
    w23 = invdet * (m23 * pa - d * pb)
    w31 = invdet * (m13 * pb - d * pa)
    w12 = 1.0 - w23 - w31
    inside = (w23 >= 0.0) & (w31 >= 0.0) & (w12 >= 0.0)
    cin = tuple(w23 * a[i] + w31 * b[i] + w12 * c[i] for i in range(3))
    e = tuple(p[i] - cin[i] for i in range(3))
    din = _d3(*e, *e)

    def seg(x1, x2):
        dv = tuple(x2[i] - x1[i] for i in range(3))
        m2 = _d3(*dv, *dv)
        s = _d3(*(x2[i] - p[i] for i in range(3)), *dv) / _at_least(m2, 1e-30)
        s = _clip01(s)
        dd = tuple(p[i] - (s * x1[i] + (1.0 - s) * x2[i]) for i in range(3))
        return _d3(*dd, *dd)

    d12 = seg(a, b)
    d13 = seg(a, c)
    d23 = seg(b, c)
    d_edge = torch.where(
        w23 > 0.0,
        torch.minimum(d12, d13),
        torch.where(w31 > 0.0, torch.minimum(d12, d23),
                    torch.minimum(d13, d23)),
    )
    return torch.where(inside, din, d_edge)
