"""Differentiable final distance evaluation: kernels R1 (forward) and R1b
(backward).

Counterpart of ``sdfgenfast_tpu/pipeline.py::_recompute_phi`` and
``_recompute_stage``. The distance pipeline (dense or binned) runs without
gradients and keeps only the closest-triangle ids ``tid``; every cell's phi
is then evaluated again from its triangle's vertices,

    phi = +-sqrt(max(d2, 1e-30)),  d2 = point_triangle_distance_sq_soa(cell,
                                                           tri_verts[tid]),

``upper`` where ``tid < 0``, negated where the parity is odd, so the
gradient reaches the vertices through the closest-point evaluation only
(the discrete fields are frozen, as the envelope theorem allows).

:func:`recompute_phi` is a ``torch.autograd.Function`` that saves only
``tri_verts``, ``tid`` and ``parity`` for backward, the counterpart of the JAX
package's ``jax.checkpoint`` with ``nothing_saveable`` per 2^20-cell chunk:

- CUDA tensors: R1 (:func:`recompute_forward`: only the path each cell's
  closest point lies on, in the form :func:`r1_config` picks per triangle
  count) and R1b
  (:func:`recompute_backward`) in ``csrc/recompute.cu``. R1b differentiates
  R1's float32 operations in reverse with autograd's rules (in exact
  arithmetic the closest point's weights: dphi/da = -sign * w_a * (p - cp)
  / d) and sums the per-cell values in float64, cast to float32 once: in a
  fixed order over the warp ranges of :func:`vjp_ranges` up to
  ``VJP_ROWS_MAX_TRIS`` triangles, by atomics above.
- CPU tensors: the plain twins. Forward evaluates the formula above by
  2^20-cell chunks; backward evaluates it again by chunks under autograd
  (the cells' gathered vertex coordinates are the leaves) and sums the
  per-cell gradients into float64, cast once.

Cell (i, j, k) sits at ``f32(i + ijk_offset[0]) * dx + origin[0]`` (world
coordinates), as in the JAX function: `ijk_offset` (None = zeros) is the
global index of a shard block's cell (0, 0, 0). ``recompute_terms.launches`` (R1's table),
``recompute_forward.launches`` and ``recompute_backward.launches`` count
kernel launches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import tracing
from ..kernels import build
from .geometry import (_at_least, _d3, gather_tri9,
                       point_triangle_distance_sq_soa)
from .vdt import sqrt_f32

__all__ = ["CHUNK_CELLS", "R1_FORMS", "VJP_ROWS_MAX_TRIS", "r1_config",
           "r1_launch", "recompute_phi", "recompute_stage",
           "recompute_forward", "recompute_terms",
           "recompute_terms_reference",
           "recompute_forward_reference", "recompute_backward",
           "recompute_backward_reference", "cell_vjp_reference",
           "vjp_ranges", "vjp_sum_groups"]

CHUNK_CELLS = 1 << 20

# R1 (csrc/recompute.cu): the triangle terms come from a per-triangle table
# of R1_TERMS floats (recompute_terms) staged in shared memory ("shared"),
# which holds at most R1_SHARED_CAP triangles (48 KB), or are computed per
# cell from the vertices ("verts"); the order of R1_FORMS is the kernel's
# PhiForm. A thread takes R1_CELLS_PER_THREAD cells at a time. r1_config
# takes the first entry of R1_CONFIGS whose M bound holds, ("verts", 1)
# past the last: at each mesh where chip_smoke.k4_r1_times timed every
# (form, cells a thread), the fastest (PERF.md section 6; H100): box36 (M
# = 36, 256 x 341 x 425) ("shared", 4); tori of 64 and 128 triangles
# (256 x 256 x 75) ("shared", 1); tori of 192-384 and 1024 triangles
# ("verts", 4); sphere82k ("verts", 1), where gathering scattered
# triangles takes the time and more threads keep more gathers in flight.
# M from 37 to 63, from 129 to 191 and from 385 to 1023 is not measured.
R1_TERMS = 32
R1_FORMS = ("shared", "verts")
R1_CELLS_PER_THREAD = (1, 4)
R1_SHARED_CAP = 384
R1_CONFIGS = ((36, ("shared", 4)), (128, ("shared", 1)),
              (1024, ("verts", 4)))

# R1b's split of the cells into contiguous warp ranges (csrc/recompute.cu):
# at least VJP_MIN_SPAN cells a range, at most VJP_MAX_RANGES ranges, three
# whole waves of the kernel on an H100 (VJP_WAVE warps: 132 SMs, 3 blocks of
# 8 warps each). Up to VJP_ROWS_MAX_TRIS triangles (ops/dense.py's
# DENSE_MAX_TRIS) each range sums into its own (M, 9) float64 row, and the
# rows take whole waves within VJP_ROW_BYTES: one wave at M = 1024, so that
# every SM holds its 24 warps (PERF.md section 6 has the times of each cap).
VJP_ROWS_MAX_TRIS = 1024
VJP_MIN_SPAN = 256
VJP_WAVE = 132 * 3 * 8
VJP_MAX_RANGES = 3 * VJP_WAVE
VJP_ROW_BYTES = 256 << 20
# the rows' sum takes groups of 32 row slices so that it runs at least
# VJP_SUM_BLOCKS blocks of 32 columns (two per SM) where the rows allow
VJP_SUM_BLOCKS = 2 * 132


def _offset(ijk_offset):
    off = (0, 0, 0) if ijk_offset is None else tuple(int(v) for v in ijk_offset)
    if len(off) != 3:
        raise ValueError(f"ijk_offset must hold three ints, got {ijk_offset}")
    return off


def _cell_positions(start: int, count: int, grid_shape, origin, dx: float,
                    device, ijk_offset=None):
    """World positions f32(index + ijk_offset) * dx + origin of flat cells
    [start, start + count) (k fastest)."""
    _, nj, nk = grid_shape
    idx = torch.arange(start, start + count, dtype=torch.int64, device=device)
    ijk = (idx // (nj * nk), (idx // nk) % nj, idx % nk)
    return tuple((c + a).to(torch.float32) * dx + o
                 for c, a, o in zip(ijk, _offset(ijk_offset), origin))


def _phi_chunk(a, b, c, p, tid, parity, upper: float):
    d2 = point_triangle_distance_sq_soa(p, a, b, c)
    d = sqrt_f32(torch.maximum(d2, d2.new_full((), 1e-30)))
    d = torch.where(tid >= 0, d, d.new_full((), upper))
    return torch.where(parity, -d, d)


def _chunks(n: int, chunk_cells: int):
    for s in range(0, n, chunk_cells):
        yield s, min(chunk_cells, n - s)


def recompute_forward_reference(tri_verts, tid, parity, origin, dx: float,
                                upper: float, chunk_cells: int = CHUNK_CELLS,
                                ijk_offset=None):
    """Plain-torch twin of :func:`recompute_forward`, by chunks of
    `chunk_cells` cells. Differentiable when called under autograd."""
    tri9 = tri_verts.reshape(-1, 9).T
    flat_tid, flat_par = tid.reshape(-1), parity.reshape(-1)
    out = []
    for s, n in _chunks(flat_tid.numel(), chunk_cells):
        t = flat_tid[s:s + n]
        p = _cell_positions(s, n, tid.shape, origin, dx, tid.device,
                            ijk_offset)
        out.append(_phi_chunk(*gather_tri9(tri9, t), p, t,
                              flat_par[s:s + n], upper))
    return torch.cat(out).reshape(tid.shape)


def _chunk_vjps(tri_verts, tid, parity, grad_phi, origin, dx: float,
                upper: float, chunk_cells: int, ijk_offset=None):
    """Per chunk of `chunk_cells` cells: (ids, the nine per-cell gradients
    with respect to the cells' gathered vertex coordinates), phi evaluated
    again under autograd."""
    tri9 = tri_verts.detach().reshape(-1, 9).T
    flat_tid, flat_par = tid.reshape(-1), parity.reshape(-1)
    flat_g = grad_phi.reshape(-1)
    for s, n in _chunks(flat_tid.numel(), chunk_cells):
        t = flat_tid[s:s + n]
        p = _cell_positions(s, n, tid.shape, origin, dx, tid.device,
                            ijk_offset)
        leaves = [v.requires_grad_() for abc in gather_tri9(tri9, t)
                  for v in abc]
        with torch.enable_grad():
            phi = _phi_chunk(tuple(leaves[0:3]), tuple(leaves[3:6]),
                             tuple(leaves[6:9]), p, t, flat_par[s:s + n],
                             upper)
            grads = torch.autograd.grad(phi, leaves, flat_g[s:s + n])
        yield t, grads


def cell_vjp_reference(tri_verts, tid, parity, grad_phi, origin, dx: float,
                       upper: float, chunk_cells: int = CHUNK_CELLS,
                       ijk_offset=None):
    """The per-cell terms of :func:`recompute_backward_reference`: (n, 9)
    float32, cell-major (k fastest), columns (a, b, c) x (x, y, z)."""
    return torch.cat([torch.stack(g, 1) for _, g in _chunk_vjps(
        tri_verts, tid, parity, grad_phi, origin, dx, upper, chunk_cells,
        ijk_offset)])


def recompute_backward_reference(tri_verts, tid, parity, grad_phi, origin,
                                 dx: float, upper: float,
                                 chunk_cells: int = CHUNK_CELLS,
                                 ijk_offset=None):
    """Plain-torch twin of :func:`recompute_backward`: every chunk's phi is
    evaluated again under autograd with the cells' gathered vertex
    coordinates as leaves; the per-cell gradients are summed per triangle
    in float64 and cast to float32 once. Returns (M, 3, 3) float32."""
    m = tri_verts.shape[0]
    acc = torch.zeros((9, m), dtype=torch.float64, device=tri_verts.device)
    for t, grads in _chunk_vjps(tri_verts, tid, parity, grad_phi, origin, dx,
                                upper, chunk_cells, ijk_offset):
        ids = torch.clamp(t, min=0).long()
        for r, g in enumerate(grads):
            acc[r].index_add_(0, ids, g.double())
    return acc.T.to(torch.float32).reshape(-1, 3, 3)


def _check(tri_verts, tid, parity, grad_phi=None):
    if (tri_verts.dtype != torch.float32 or tri_verts.dim() != 3
            or tuple(tri_verts.shape[1:]) != (3, 3)):
        raise ValueError(f"tri_verts must be (M, 3, 3) float32, got "
                         f"{tuple(tri_verts.shape)} {tri_verts.dtype}")
    if tid.dtype != torch.int32 or tid.dim() != 3:
        raise ValueError(f"tid must be (ni, nj, nk) int32, got "
                         f"{tuple(tid.shape)} {tid.dtype}")
    if parity.dtype != torch.bool or parity.shape != tid.shape:
        raise ValueError(f"parity must be bool {tuple(tid.shape)}, got "
                         f"{tuple(parity.shape)} {parity.dtype}")
    if grad_phi is not None and (grad_phi.dtype != torch.float32
                                 or grad_phi.shape != tid.shape):
        raise ValueError(f"grad_phi must be float32 {tuple(tid.shape)}, "
                         f"got {tuple(grad_phi.shape)} {grad_phi.dtype}")
    devices = {x.device for x in (tri_verts, tid, parity, grad_phi)
               if x is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return devices.pop()


def vjp_ranges(n: int, m: int):
    """(ranges, span) of R1b on n > 0 cells and m > 0 triangles: range w
    holds the cells [w * span, min((w + 1) * span, n)), span a multiple of
    32."""
    cap = VJP_MAX_RANGES
    if m <= VJP_ROWS_MAX_TRIS:
        cap = min(cap, VJP_ROW_BYTES // (72 * m) // VJP_WAVE * VJP_WAVE)
    want = min(cap, -(-n // VJP_MIN_SPAN))
    span = -(-(-(-n // want)) // 32) * 32
    return -(-n // span), span


def vjp_sum_groups(ranges: int, m: int) -> int:
    """Groups of 32 row slices in the sum of `ranges` rows of m triangles:
    enough for VJP_SUM_BLOCKS blocks of 32 of the 9 m columns, at most one
    slice per row, at least one group."""
    blocks = -(-9 * m // 32)
    return max(1, min(-(-VJP_SUM_BLOCKS // blocks), ranges // 32))


def _launch(entry: str, tensors, tid, origin, dx: float, ijk_offset, tail,
            out):
    lib = build.library()
    with torch.cuda.device(tid.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(getattr(lib, entry)(
            *(x.data_ptr() for x in tensors), tid.numel(), tid.shape[1],
            tid.shape[2], *_offset(ijk_offset), *(float(o) for o in origin),
            float(dx), *tail, out.data_ptr(), stream), entry)


def r1_config(m: int):
    """R1's (form, cells per thread) at m triangles (R1_CONFIGS)."""
    return next((c for top, c in R1_CONFIGS if m <= top), ("verts", 1))


def recompute_terms_reference(tri_verts):
    """Plain-torch twin of :func:`recompute_terms`: the terms with
    point_triangle_distance_sq_soa's operations."""
    a, b, c = (tuple(tri_verts[:, r, q] for q in range(3)) for r in range(3))
    x13 = tuple(a[q] - c[q] for q in range(3))
    x23 = tuple(b[q] - c[q] for q in range(3))
    m13, m23, d = _d3(*x13, *x13), _d3(*x23, *x23), _d3(*x13, *x23)
    invdet = 1.0 / _at_least(m13 * m23 - d * d, 1e-30)
    cols = [*a, *b, *c, invdet, m13, m23, *x13, d, *x23,
            torch.zeros_like(m13)]
    for x1, x2 in ((a, b), (a, c), (b, c)):
        dv = tuple(x2[q] - x1[q] for q in range(3))
        cols += [*dv, _at_least(_d3(*dv, *dv), 1e-30)]
    return torch.stack(cols, 1)


def recompute_terms(tri_verts):
    """R1's per-triangle table, (M, R1_TERMS) float32 from (M, 3, 3)
    float32 vertices: a, b, c, invdet, m13, m23; x13 = a - c, d; x23 = b -
    c, 0; per edge ab, ac, bc: dv = x2 - x1 and max(|dv|^2, 1e-30); each
    with the operations of triangle_case and seg_closest (geometry.cuh).
    CUDA: one launch of recompute_terms_kernel. CPU:
    :func:`recompute_terms_reference`."""
    if (tri_verts.dtype != torch.float32 or tri_verts.dim() != 3
            or tuple(tri_verts.shape[1:]) != (3, 3)):
        raise ValueError(f"tri_verts must be (M, 3, 3) float32, got "
                         f"{tuple(tri_verts.shape)} {tri_verts.dtype}")
    if tri_verts.device.type == "cpu":
        return recompute_terms_reference(tri_verts)
    if tri_verts.device.type != "cuda":
        raise ValueError(f"recompute_terms: unsupported device "
                         f"{tri_verts.device}")
    tri_verts = tri_verts.contiguous()
    table = torch.empty((tri_verts.shape[0], R1_TERMS), dtype=torch.float32,
                        device=tri_verts.device)
    with torch.cuda.device(tri_verts.device):
        build.check(build.library().sdf_recompute_terms(
            tri_verts.data_ptr(), tri_verts.shape[0], table.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "sdf_recompute_terms")
    recompute_terms.launches += 1
    return table


recompute_terms.launches = 0


def _aligned(x, nbytes: int):
    """`x` contiguous, at an address that is a multiple of `nbytes` (a copy
    where a view starts elsewhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % nbytes == 0 else x.clone()


def recompute_forward(tri_verts, tid, parity, origin, dx: float,
                      upper: float, ijk_offset=None):
    """Signed phi (ni, nj, nk) float32 from the frozen ids and parity.
    CUDA: R1 in :func:`r1_config`'s form (:func:`r1_launch`). CPU:
    :func:`recompute_forward_reference`."""
    device = _check(tri_verts, tid, parity)
    if device.type == "cpu":
        return recompute_forward_reference(tri_verts, tid, parity, origin,
                                           dx, upper, ijk_offset=ijk_offset)
    if device.type != "cuda":
        raise ValueError(f"recompute_forward: unsupported device {device}")
    return r1_launch(tri_verts, tid, parity, origin, dx, upper,
                     *r1_config(tri_verts.shape[0]), ijk_offset=ijk_offset)


def r1_launch(tri_verts, tid, parity, origin, dx: float, upper: float,
              form: str, cells_per_thread: int, ijk_offset=None):
    """R1 on CUDA tensors: the triangle terms from `form` (one of R1_FORMS;
    "shared" first builds the table, :func:`recompute_terms`),
    `cells_per_thread` (one of R1_CELLS_PER_THREAD) cells a thread at a
    time. The cells' launch is counted in ``recompute_forward.launches``."""
    device = _check(tri_verts, tid, parity)
    m = tri_verts.shape[0]
    if (device.type != "cuda" or form not in R1_FORMS
            or cells_per_thread not in R1_CELLS_PER_THREAD
            or (form == "shared" and m > R1_SHARED_CAP)):
        raise ValueError(f"r1_launch: form {form!r}, {cells_per_thread} "
                         f"cells a thread at {m} triangles on {device}")
    tri_verts = tri_verts.contiguous()
    tid = _aligned(tid, 4 * cells_per_thread)
    parity = _aligned(parity, cells_per_thread)
    table = (recompute_terms(tri_verts) if form == "shared" and m > 0 else
             torch.empty((0, R1_TERMS), dtype=torch.float32, device=device))
    phi = torch.empty(tid.shape, dtype=torch.float32, device=device)
    _launch("sdf_recompute_phi", (tri_verts, table, tid, parity), tid, origin,
            dx, ijk_offset,
            (float(upper), m, R1_FORMS.index(form), cells_per_thread), phi)
    recompute_forward.launches += 1
    return phi


recompute_forward.launches = 0


def recompute_backward(tri_verts, tid, parity, grad_phi, origin, dx: float,
                       upper: float, ijk_offset=None):
    """Vertex gradient (M, 3, 3) float32 of <grad_phi, phi>. CUDA: one R1b
    call. Up to VJP_ROWS_MAX_TRIS triangles its sum is atomic-free and in
    a fixed order (per-range float64 rows with a mask of the triangles each
    range flushed, then the flushed entries summed and cast); above,
    float64 atomics into one accumulator, cast once. CPU:
    :func:`recompute_backward_reference`."""
    device = _check(tri_verts, tid, parity, grad_phi)
    if device.type == "cpu":
        return recompute_backward_reference(tri_verts, tid, parity, grad_phi,
                                            origin, dx, upper,
                                            ijk_offset=ijk_offset)
    if device.type != "cuda":
        raise ValueError(f"recompute_backward: unsupported device {device}")
    tensors = [x.detach().contiguous()
               for x in (tri_verts, tid, parity, grad_phi)]
    m = tri_verts.shape[0]
    if tid.numel() == 0 or m == 0:
        return torch.zeros(tri_verts.shape, dtype=torch.float32, device=device)
    ranges, span = vjp_ranges(tid.numel(), m)
    if m <= VJP_ROWS_MAX_TRIS:
        groups = vjp_sum_groups(ranges, m)
        rows = torch.empty((ranges, m, 9), dtype=torch.float64, device=device)
        masks = torch.empty((ranges, 32), dtype=torch.int32, device=device)
        parts = torch.empty((groups, m, 9), dtype=torch.float64, device=device)
        grad = torch.empty(tri_verts.shape, dtype=torch.float32, device=device)
        _launch("sdf_recompute_vjp_rows", tensors, tensors[1], origin, dx,
                ijk_offset, (span, ranges, m, groups, rows.data_ptr(), masks.data_ptr(),
                 parts.data_ptr()), grad)
    else:
        acc = torch.zeros(tri_verts.shape, dtype=torch.float64, device=device)
        _launch("sdf_recompute_vjp", tensors, tensors[1], origin, dx,
                ijk_offset, (span, ranges), acc)
        grad = acc.to(torch.float32)
    recompute_backward.launches += 1
    return grad


recompute_backward.launches = 0


class _RecomputePhi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tri_verts, tid, parity, origin, dx, upper, ijk_offset):
        ctx.save_for_backward(tri_verts, tid, parity)
        ctx.origin, ctx.dx, ctx.upper = origin, dx, upper
        ctx.ijk_offset = ijk_offset
        with tracing.span("sdf.recompute.forward", tid.device):
            return recompute_forward(tri_verts.detach(), tid, parity, origin,
                                     dx, upper, ijk_offset=ijk_offset)

    @staticmethod
    def backward(ctx, grad_phi):
        tri_verts, tid, parity = ctx.saved_tensors
        # for CUDA tensors autograd runs this on its device thread, where
        # no span is open: a root span
        with tracing.span("sdf.recompute.backward", tid.device):
            grad = recompute_backward(tri_verts, tid, parity,
                                      grad_phi.contiguous(), ctx.origin,
                                      ctx.dx, ctx.upper,
                                      ijk_offset=ctx.ijk_offset)
        return grad, None, None, None, None, None, None


def recompute_phi(tri_verts, tid, parity, origin: Sequence[float], dx: float,
                  upper: float, ijk_offset=None):
    """phi(cell) = sign * distance(cell, tri_verts[tid]), differentiable in
    `tri_verts` ((M, 3, 3) float32). tid (ni, nj, nk) int32, parity bool of
    the same shape, on the device of tri_verts; origin three float32-
    representable floats, dx and upper floats; ijk_offset the global
    (i, j, k) of cell (0, 0, 0) (None = zeros)."""
    origin = tuple(float(np.float32(o)) for o in origin)
    return _RecomputePhi.apply(tri_verts, tid, parity, origin,
                               float(np.float32(dx)), float(np.float32(upper)),
                               _offset(ijk_offset))


def recompute_stage(tri_verts, tid, parity, origin: Sequence[float],
                    dx: float, ijk_offset=None, grid_shape=None):
    """:func:`recompute_phi` with the reference's far value
    ``upper = f32(ni + nj + nk) * dx`` (cpu_lib/makelevelset3.cpp:197) of
    `grid_shape` (default: tid's; a shard's block passes the global grid's
    and its `ijk_offset`)."""
    shape = tid.shape if grid_shape is None else grid_shape
    upper = np.float32(sum(shape)) * np.float32(dx)
    return recompute_phi(tri_verts, tid, parity, origin, dx, float(upper),
                         ijk_offset)
