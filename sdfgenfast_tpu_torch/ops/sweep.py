"""Far-field completion for ``far_field="propagate"`` and ``"eikonal"``, in
plain torch on the tensors' device.

Counterpart of ``sdfgenfast_tpu/ops/sweep.py``: one grid, or (the eikonal
iterations) the blocks of a sharded grid in lockstep through
``halo_extend``, JAX's ``extend_fn``. The sharded plane scans are
``parallel/sharded._sharded_propagate``, from this module's plane pieces.

``propagate`` (the reference CPU backend's semantics,
``cpu_lib/makelevelset3.cpp:90-151, 243-292``): directional plane scans
carry closest-triangle ids from each plane to the next; every cell of a
plane re-evaluates the exact distance to the 9 ids of its neighbours in the
previous plane and adopts a strictly smaller one. Both directions of all
three axes make a pass; passes repeat until one changes nothing or
``max_passes`` is reached. The plane scan is a host loop of plane updates,
and each pass ends in one host sync for the convergence test.

``eikonal`` (the reference CUDA backend's semantics,
``gpu_lib/makelevelset3_gpu.cu:487-551``): Jacobi relaxation of
|grad phi| = 1 outside the frozen band, with the sorted axis-wise minimum
neighbours and the closed-form 1D/2D/3D updates.

Every square root goes through ``ops/vdt.sqrt_f32`` (PyTorch's CPU float32
sqrt is not correctly rounded).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import point_triangle_distance_sq
from .vdt import sqrt_f32

__all__ = ["propagate_closest_triangles", "eikonal_far_field"]

_SHIFTS = [(dj, dk) for dj in (-1, 0, 1) for dk in (-1, 0, 1)]


def shift_stack(ext):
    """The 9 shifts of a (nB, nC) plane in _SHIFTS order from the plane
    extended by one cell on each side, `ext` ((nB + 2, nC + 2)):
    out[m][r, c] = x[r - dj, c - dk] for _SHIFTS[m] = (dj, dk) (the argmin's
    tie order follows _SHIFTS)."""
    B, C = ext.shape[0] - 2, ext.shape[1] - 2
    return torch.stack([ext[1 - dj:1 - dj + B, 1 - dk:1 - dk + C]
                        for dj, dk in _SHIFTS])


def _shift_planes(x, fill):
    """The 9 shifts of a (nB, nC) plane, `fill` where they lie outside the
    plane (the JAX package's ``_shift_plane``)."""
    B, C = x.shape
    xp = x.new_full((B + 2, C + 2), fill)
    xp[1:-1, 1:-1] = x
    return shift_stack(xp)


def plane_geometry(pos_axes, axis):
    """The world positions of a scan along `axis`: (gx0, plane_pos), the
    (nB, nC, 3) in-plane positions with 0 in the scanned coordinate and the
    (nA, 3) scanned coordinate of each plane with 0 in the others; a plane
    a sits at gx0 + plane_pos[a]. `pos_axes` are the three axes' position
    tables."""
    other = [a for a in range(3) if a != axis]
    dev = pos_axes[0].device
    B, C = (pos_axes[a].shape[0] for a in other)
    gx0 = torch.zeros((B, C, 3), dtype=torch.float32, device=dev)
    gx0[..., other[0]] = pos_axes[other[0]][:, None]
    gx0[..., other[1]] = pos_axes[other[1]][None, :]
    onehot = torch.zeros(3, dtype=torch.float32, device=dev)
    onehot[axis] = 1.0
    return gx0, pos_axes[axis][:, None] * onehot  # exact


def plane_update(cand_tid, cur_phi, cur_tid, tri_verts, gx):
    """One plane's relaxation: the exact distance from each cell position
    `gx` ((1, nB, nC, 3)) to each of its 9 candidate ids `cand_tid` ((9, nB,
    nC), -1 invalid), the first minimum over the 9 (also when all are
    invalid), adopted where strictly below `cur_phi` (check_neighbour,
    makelevelset3.cpp:90-97). Returns the plane's (phi, tid)."""
    valid = cand_tid >= 0
    tv = tri_verts[torch.clamp(cand_tid, min=0).to(torch.int64)]
    d2 = point_triangle_distance_sq(gx, tv[..., 0, :], tv[..., 1, :],
                                    tv[..., 2, :])
    d2 = torch.where(valid, d2, float("inf"))
    amin = torch.argmin(d2, dim=0, keepdim=True)
    dmin2 = torch.gather(d2, 0, amin)[0]
    best_tid = torch.gather(cand_tid, 0, amin)[0]
    d = sqrt_f32(dmin2)
    better = d < cur_phi
    return (torch.where(better, d, cur_phi),
            torch.where(better, best_tid, cur_tid))


def scan_copy(x, axis):
    """A contiguous copy of `x` with `axis` first: the planes of a scan
    (a copy also for axis 0, so that the scan never writes its input)."""
    return x.movedim(axis, 0).clone(memory_format=torch.contiguous_format)


def scan_order(n: int, reverse: bool):
    return list(range(n - 1, -1, -1) if reverse else range(n))


def _sweep_axis(phi, tid, tri_verts, pos_axes, axis, reverse):
    """One directional plane scan along `axis` over (ni, nj, nk) phi / tid:
    plane a takes its candidates from plane a - 1 as already updated (a + 1
    when `reverse`); the first plane is kept. The inputs are not written."""
    out_phi, out_tid = (scan_copy(x, axis) for x in (phi, tid))
    gx0, plane_pos = plane_geometry(pos_axes, axis)
    order = scan_order(out_phi.shape[0], reverse)
    prev_tid = out_tid[order[0]]
    for a in order[1:]:
        gx = (gx0 + plane_pos[a])[None]
        new_phi, new_tid = plane_update(_shift_planes(prev_tid, -1),
                                        out_phi[a], out_tid[a], tri_verts, gx)
        out_phi[a] = new_phi
        out_tid[a] = new_tid
        prev_tid = new_tid
    return (out_phi.movedim(0, axis).contiguous(),
            out_tid.movedim(0, axis).contiguous())


def propagate_closest_triangles(phi, tid, tri_verts, origin, dx: float,
                                max_passes: int = 8):
    """Directional plane scans until a pass changes no phi (or `max_passes`
    passes ran). phi (ni, nj, nk) float32 seeded in the band, tid int32 (-1
    unseeded), tri_verts (M, 3, 3) float32 world vertices, origin (3,)
    float32 tensor, dx a float32-representable float. Returns (phi, tid,
    the number of passes run)."""
    pos_axes = tuple(
        torch.arange(n, dtype=torch.float32, device=phi.device) * dx
        + origin[a] for a, n in enumerate(phi.shape))
    passes = 0
    while passes < max_passes:
        phi0 = phi
        for axis in (0, 1, 2):
            for reverse in (False, True):
                phi, tid = _sweep_axis(phi, tid, tri_verts, pos_axes, axis,
                                       reverse)
        passes += 1
        if not bool((phi != phi0).any()):  # one host sync a pass
            break
    return phi, tid, passes


def _face_min(ext, axis: int, n: int):
    """The smaller of each cell's two neighbours along `axis` from `ext`,
    the block extended by one cell on each side of `axis`."""
    return torch.minimum(ext.narrow(axis, 0, n), ext.narrow(axis, 2, n))


def _axis_min_neighbors(phi, axes=(0, 1, 2)):
    """Per axis of `axes`, the smaller of each cell's two face neighbours,
    +inf beyond the block."""
    mins = []
    for axis in axes:
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
        ext = F.pad(phi[None], pad, value=float("inf"))[0]
        mins.append(_face_min(ext, axis, phi.shape[axis]))
    return mins


def _sort3(x, y, z):
    """Elementwise ascending sort of three tensors, by min and max (every
    output is one of the inputs, so the values are exactly a sort's)."""
    lo, hi = torch.minimum(x, y), torch.maximum(x, y)
    return (torch.minimum(lo, z), torch.maximum(lo, torch.minimum(hi, z)),
            torch.maximum(hi, z))


def _eikonal_update(phi, frozen, mins, dx: float, three):
    """One Jacobi iteration of a block from its axis-wise minimum
    neighbours `mins`."""
    dx32 = np.float32(dx)
    two_dx2 = float(np.float32(2.0) * dx32 * dx32)  # 2.0 * dx * dx in f32
    dx2 = float(dx32 * dx32)
    a, b, c = _sort3(*mins)
    x1 = a + float(dx32)
    ab = a - b
    s2 = two_dx2 - ab * ab
    x2 = 0.5 * (a + b + sqrt_f32(torch.clamp(s2, min=0.0)))
    ss = a + b + c
    s3 = ss * ss - 3.0 * (a * a + b * b + c * c - dx2)
    x3 = (ss + sqrt_f32(torch.clamp(s3, min=0.0))) / three
    upd = torch.where(x1 <= b, x1, torch.where(x2 <= c, x2, x3))
    upd = torch.where(torch.isfinite(a), upd, phi)  # isolated: keep
    return torch.where(frozen, phi, torch.minimum(phi, upd))


def eikonal_far_field(phi, frozen, dx: float, num_iters: int,
                      halo_extend=None):
    """`num_iters` Jacobi iterations of |grad phi| = 1 outside `frozen`
    (fast_sweep_eikonal_kernel, gpu_lib/makelevelset3_gpu.cu:487-551): the
    axis-wise minimum neighbours sorted a <= b <= c, the 1D update a + dx
    where it does not exceed b, else the 2D update where it does not exceed
    c, else the 3D one; a cell with no finite neighbour keeps its value.
    phi (ni, nj, nk) float32, frozen bool, dx a float32-representable
    float.

    Blocks of a grid sharded on j and k: with `halo_extend`, `phi` and
    `frozen` are sequences with one block each, and ``halo_extend(phis,
    axis)`` returns every block extended by one cell on each side of `axis`
    (1 or 2) with its neighbours' cells, +inf beyond the grid. The 6-point
    stencil reads no corner, so each axis extends on its own; i, not
    sharded, is padded locally. The blocks advance in lockstep, so each
    iteration equals the iteration over the whole grid. Returns a list of
    blocks."""
    if halo_extend is None:
        # a tensor divisor: PyTorch's CUDA kernels multiply by the
        # reciprocal of a Python scalar divisor, which rounds differently
        # from a / 3
        three = phi.new_tensor(3.0)
        for _ in range(num_iters):
            phi = _eikonal_update(phi, frozen, _axis_min_neighbors(phi), dx,
                                  three)
        return phi
    phis = list(phi)
    threes = [p.new_tensor(3.0) for p in phis]
    for _ in range(num_iters):
        ext_j, ext_k = halo_extend(phis, 1), halo_extend(phis, 2)
        phis = [_eikonal_update(p, f, (
            _axis_min_neighbors(p, (0,))[0], _face_min(ej, 1, p.shape[1]),
            _face_min(ek, 2, p.shape[2])), dx, three)
            for p, f, ej, ek, three in zip(phis, frozen, ext_j, ext_k,
                                           threes)]
    return phis
