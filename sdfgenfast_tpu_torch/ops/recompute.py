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

- CUDA tensors: R1 (:func:`recompute_forward`) and R1b
  (:func:`recompute_backward`) in ``csrc/recompute.cu``. R1b differentiates
  R1's float32 operations in reverse with autograd's rules (in exact
  arithmetic the closest point's weights: dphi/da = -sign * w_a * (p - cp)
  / d) and sums the per-cell values in float64, cast to float32 once.
- CPU tensors: the plain twins. Forward evaluates the formula above by
  2^20-cell chunks; backward evaluates it again by chunks under autograd
  (the cells' gathered vertex coordinates are the leaves) and sums the
  per-cell gradients into float64, cast once.

Cell (i, j, k) sits at ``f32(i) * dx + origin[0]`` (world coordinates), as
in the JAX function. ``recompute_forward.launches`` and
``recompute_backward.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels import build
from .geometry import gather_tri9, point_triangle_distance_sq_soa
from .vdt import sqrt_f32

__all__ = ["CHUNK_CELLS", "recompute_phi", "recompute_stage",
           "recompute_forward", "recompute_forward_reference",
           "recompute_backward", "recompute_backward_reference"]

CHUNK_CELLS = 1 << 20


def _cell_positions(start: int, count: int, grid_shape, origin, dx: float,
                    device):
    """World positions f32(index) * dx + origin of flat cells
    [start, start + count) (k fastest)."""
    _, nj, nk = grid_shape
    idx = torch.arange(start, start + count, dtype=torch.int64, device=device)
    ijk = (idx // (nj * nk), (idx // nk) % nj, idx % nk)
    return tuple(c.to(torch.float32) * dx + o for c, o in zip(ijk, origin))


def _phi_chunk(a, b, c, p, tid, parity, upper: float):
    d2 = point_triangle_distance_sq_soa(p, a, b, c)
    d = sqrt_f32(torch.maximum(d2, d2.new_full((), 1e-30)))
    d = torch.where(tid >= 0, d, d.new_full((), upper))
    return torch.where(parity, -d, d)


def _chunks(n: int, chunk_cells: int):
    for s in range(0, n, chunk_cells):
        yield s, min(chunk_cells, n - s)


def recompute_forward_reference(tri_verts, tid, parity, origin, dx: float,
                                upper: float, chunk_cells: int = CHUNK_CELLS):
    """Plain-torch twin of :func:`recompute_forward`, by chunks of
    `chunk_cells` cells. Differentiable when called under autograd."""
    tri9 = tri_verts.reshape(-1, 9).T
    flat_tid, flat_par = tid.reshape(-1), parity.reshape(-1)
    out = []
    for s, n in _chunks(flat_tid.numel(), chunk_cells):
        t = flat_tid[s:s + n]
        p = _cell_positions(s, n, tid.shape, origin, dx, tid.device)
        out.append(_phi_chunk(*gather_tri9(tri9, t), p, t,
                              flat_par[s:s + n], upper))
    return torch.cat(out).reshape(tid.shape)


def recompute_backward_reference(tri_verts, tid, parity, grad_phi, origin,
                                 dx: float, upper: float,
                                 chunk_cells: int = CHUNK_CELLS):
    """Plain-torch twin of :func:`recompute_backward`: every chunk's phi is
    evaluated again under autograd with the cells' gathered vertex
    coordinates as leaves; the per-cell gradients are summed per triangle
    in float64 and cast to float32 once. Returns (M, 3, 3) float32."""
    tri9 = tri_verts.detach().reshape(-1, 9).T
    flat_tid, flat_par = tid.reshape(-1), parity.reshape(-1)
    flat_g = grad_phi.reshape(-1)
    acc = torch.zeros((9, tri9.shape[1]), dtype=torch.float64,
                      device=tri9.device)
    for s, n in _chunks(flat_tid.numel(), chunk_cells):
        t = flat_tid[s:s + n]
        p = _cell_positions(s, n, tid.shape, origin, dx, tid.device)
        leaves = [v.requires_grad_() for abc in gather_tri9(tri9, t)
                  for v in abc]
        with torch.enable_grad():
            phi = _phi_chunk(tuple(leaves[0:3]), tuple(leaves[3:6]),
                             tuple(leaves[6:9]), p, t, flat_par[s:s + n],
                             upper)
            grads = torch.autograd.grad(phi, leaves, flat_g[s:s + n])
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


def _launch(entry: str, tensors, tid, origin, dx: float, tail, out):
    lib = build.library()
    with torch.cuda.device(tid.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(getattr(lib, entry)(
            *(x.data_ptr() for x in tensors), tid.numel(), tid.shape[1],
            tid.shape[2], *(float(o) for o in origin), float(dx), *tail,
            out.data_ptr(), stream), entry)


def recompute_forward(tri_verts, tid, parity, origin, dx: float,
                      upper: float):
    """Signed phi (ni, nj, nk) float32 from the frozen ids and parity.
    CUDA: one R1 launch. CPU: :func:`recompute_forward_reference`."""
    device = _check(tri_verts, tid, parity)
    if device.type == "cpu":
        return recompute_forward_reference(tri_verts, tid, parity, origin,
                                           dx, upper)
    if device.type != "cuda":
        raise ValueError(f"recompute_forward: unsupported device {device}")
    tri_verts, tid, parity = (x.contiguous() for x in (tri_verts, tid, parity))
    phi = torch.empty(tid.shape, dtype=torch.float32, device=device)
    _launch("sdf_recompute_phi", (tri_verts, tid, parity), tid, origin, dx,
            (float(upper),), phi)
    recompute_forward.launches += 1
    return phi


recompute_forward.launches = 0


def recompute_backward(tri_verts, tid, parity, grad_phi, origin, dx: float,
                       upper: float):
    """Vertex gradient (M, 3, 3) float32 of <grad_phi, phi>. CUDA: one R1b
    launch into a float64 accumulator, cast once. CPU:
    :func:`recompute_backward_reference`."""
    device = _check(tri_verts, tid, parity, grad_phi)
    if device.type == "cpu":
        return recompute_backward_reference(tri_verts, tid, parity, grad_phi,
                                            origin, dx, upper)
    if device.type != "cuda":
        raise ValueError(f"recompute_backward: unsupported device {device}")
    tensors = [x.detach().contiguous()
               for x in (tri_verts, tid, parity, grad_phi)]
    acc = torch.zeros(tri_verts.shape, dtype=torch.float64, device=device)
    _launch("sdf_recompute_vjp", tensors, tensors[1], origin, dx, (), acc)
    recompute_backward.launches += 1
    return acc.to(torch.float32)


recompute_backward.launches = 0


class _RecomputePhi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tri_verts, tid, parity, origin, dx, upper):
        ctx.save_for_backward(tri_verts, tid, parity)
        ctx.origin, ctx.dx, ctx.upper = origin, dx, upper
        return recompute_forward(tri_verts.detach(), tid, parity, origin, dx,
                                 upper)

    @staticmethod
    def backward(ctx, grad_phi):
        tri_verts, tid, parity = ctx.saved_tensors
        grad = recompute_backward(tri_verts, tid, parity,
                                  grad_phi.contiguous(), ctx.origin, ctx.dx,
                                  ctx.upper)
        return grad, None, None, None, None, None


def recompute_phi(tri_verts, tid, parity, origin: Sequence[float], dx: float,
                  upper: float):
    """phi(cell) = sign * distance(cell, tri_verts[tid]), differentiable in
    `tri_verts` ((M, 3, 3) float32). tid (ni, nj, nk) int32, parity bool of
    the same shape, on the device of tri_verts; origin three float32-
    representable floats, dx and upper floats."""
    origin = tuple(float(np.float32(o)) for o in origin)
    return _RecomputePhi.apply(tri_verts, tid, parity, origin,
                               float(np.float32(dx)), float(np.float32(upper)))


def recompute_stage(tri_verts, tid, parity, origin: Sequence[float],
                    dx: float):
    """:func:`recompute_phi` with the reference's far value
    ``upper = f32(ni + nj + nk) * dx`` (cpu_lib/makelevelset3.cpp:197)."""
    upper = np.float32(sum(tid.shape)) * np.float32(dx)
    return recompute_phi(tri_verts, tid, parity, origin, dx, float(upper))
