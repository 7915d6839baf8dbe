"""Point-triangle distance in PyTorch (float32): the structure-of-arrays
form and the stacked (..., 3) form.

Counterpart of ``sdfgenfast_tpu/ops/geometry.py`` (every name of its
``__all__``): the reference's case analysis and
clamping (``point_segment_distance`` / ``point_triangle_distance``,
cpu_lib/makelevelset3.cpp:21-70) as branchless tensor code. The SoA form is
the per-triangle body of the recompute kernel R1 (``csrc/recompute.cu``) and
of its plain twin, so the operation order is the JAX package's, step for
step: the CUDA kernel repeats it with ``--fmad=false``. The stacked form is
the plane scan's (``ops/sweep.py``); its dot products sum their three
products in a fixed order (x, then y, then z), so that the CPU and the card
evaluate one expression.

Under autograd it differentiates as the JAX function does: the clamps are
``maximum``/``minimum`` pairs (as ``jnp.clip`` and ``jnp.maximum`` are), so
a value exactly on a clamp bound passes half its gradient, where
``torch.clamp`` would pass all of it.
"""

from __future__ import annotations

import torch

from .vdt import sqrt_f32

__all__ = ["gather_tri9", "point_segment_distance_sq",
           "point_triangle_distance_sq", "point_triangle_distance_sq_soa",
           "point_triangle_distance", "closest_point_weights"]


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


def _dot(a, b):
    """Dot product over the last axis of size 3, summed x + y + z."""
    ab = a * b
    return ab[..., 0] + ab[..., 1] + ab[..., 2]


def point_segment_distance_sq(x0, x1, x2):
    """Squared distance from x0 to the segment [x1, x2], (..., 3) tensors
    that broadcast: s12 = clamp(dot(x2 - x0, x2 - x1) / |x2 - x1|^2) weighs
    x1, 1 - s12 weighs x2 (cpu_lib/makelevelset3.cpp:21-34)."""
    d = x2 - x1
    m2 = _dot(d, d)
    s12 = _clip01(_dot(x2 - x0, d) / _at_least(m2, 1e-30))
    c = s12[..., None] * x1 + (1.0 - s12)[..., None] * x2
    diff = x0 - c
    return _dot(diff, diff)


def _triangle_case(x0, x1, x2, x3):
    """Barycentric weights of x0's projection on the plane of (x1, x2, x3):
    (w23 on x1, w31 on x2, w12 on x3, inside), the reference's names
    (cpu_lib/makelevelset3.cpp:51-59)."""
    x13 = x1 - x3
    x23 = x2 - x3
    x03 = x0 - x3
    m13 = _dot(x13, x13)
    m23 = _dot(x23, x23)
    d = _dot(x13, x23)
    invdet = 1.0 / _at_least(m13 * m23 - d * d, 1e-30)
    a = _dot(x13, x03)
    b = _dot(x23, x03)
    w23 = invdet * (m23 * a - d * b)
    w31 = invdet * (m13 * b - d * a)
    w12 = 1.0 - w23 - w31
    inside = (w23 >= 0.0) & (w31 >= 0.0) & (w12 >= 0.0)
    return w23, w31, w12, inside


def point_triangle_distance_sq(x0, x1, x2, x3):
    """Squared distance from points x0 to triangles (x1, x2, x3), (..., 3)
    float32 tensors that broadcast over the leading axes."""
    w23, w31, w12, inside = _triangle_case(x0, x1, x2, x3)
    c_in = w23[..., None] * x1 + w31[..., None] * x2 + w12[..., None] * x3
    diff = x0 - c_in
    d_in = _dot(diff, diff)
    d12 = point_segment_distance_sq(x0, x1, x2)
    d13 = point_segment_distance_sq(x0, x1, x3)
    d23 = point_segment_distance_sq(x0, x2, x3)
    # the case selection of cpu_lib/makelevelset3.cpp:62-69
    d_edge = torch.where(
        w23 > 0.0, torch.minimum(d12, d13),
        torch.where(w31 > 0.0, torch.minimum(d12, d23),
                    torch.minimum(d13, d23)))
    return torch.where(inside, d_in, d_edge)


def point_triangle_distance(x0, x1, x2, x3):
    """Distance from points x0 to triangles (x1, x2, x3): the correctly
    rounded square root of :func:`point_triangle_distance_sq`."""
    return sqrt_f32(point_triangle_distance_sq(x0, x1, x2, x3))


def _segment_weight(x0, x1, x2):
    d = x2 - x1
    return _clip01(_dot(x2 - x0, d) / _at_least(_dot(d, d), 1e-30))


def closest_point_weights(x0, x1, x2, x3):
    """Barycentric weights (w1, w2, w3) of the closest point on each
    triangle, closest = w1 * x1 + w2 * x2 + w3 * x3, with the region
    selection of :func:`point_triangle_distance_sq`: the plane weights
    inside, else the weights along the nearer of the two edges the case
    names (the first at a tie). At region boundaries the closest point is
    continuous, so any consistent choice gives a valid (sub)gradient."""
    w23, w31, w12, inside = _triangle_case(x0, x1, x2, x3)
    s12 = _segment_weight(x0, x1, x2)  # the weight on x1 along (x1, x2)
    s13 = _segment_weight(x0, x1, x3)
    s23 = _segment_weight(x0, x2, x3)
    d12 = point_segment_distance_sq(x0, x1, x2)
    d13 = point_segment_distance_sq(x0, x1, x3)
    d23 = point_segment_distance_sq(x0, x2, x3)
    dt = x0.dtype
    zeros = torch.zeros_like(s12)

    def edge_weights(sel12, sel13, sel23):
        # a one-hot choice of edge -> its barycentric triple
        return (sel12 * s12 + sel13 * s13,
                sel12 * (1.0 - s12) + sel23 * s23,
                sel13 * (1.0 - s13) + sel23 * (1.0 - s23))

    use12_a = (d12 <= d13).to(dt)  # region w23 > 0: edges 12 and 13
    use12_b = (d12 <= d23).to(dt)  # region w31 > 0: edges 12 and 23
    use13_c = (d13 <= d23).to(dt)  # otherwise: edges 13 and 23
    wa = edge_weights(use12_a, 1.0 - use12_a, zeros)
    wb = edge_weights(use12_b, zeros, 1.0 - use12_b)
    wc = edge_weights(zeros, use13_c, 1.0 - use13_c)
    a, b = w23 > 0.0, w31 > 0.0
    in_a = (a & ~inside).to(dt)
    in_b = (b & ~a & ~inside).to(dt)
    in_c = (~a & ~b & ~inside).to(dt)
    ins = inside.to(dt)
    return tuple(ins * w + in_a * ea + in_b * eb + in_c * ec
                 for w, ea, eb, ec in zip((w23, w31, w12), wa, wb, wc))
