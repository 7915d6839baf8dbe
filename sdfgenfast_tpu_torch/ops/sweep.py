"""Far-field completion for ``far_field="propagate"`` and ``"eikonal"``, in
plain torch on the tensors' device.

Counterpart of ``sdfgenfast_tpu/ops/sweep.py`` on one device (the sharded
``extend_fn`` is not ported).

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


def _shift_planes(x, fill):
    """The 9 shifts of a (nB, nC) plane in _SHIFTS order, edge-filled:
    out[m][r, c] = x[r - dj, c - dk] for _SHIFTS[m] = (dj, dk), `fill` where
    that lies outside the plane (the JAX package's ``_shift_plane``)."""
    B, C = x.shape
    xp = x.new_full((B + 2, C + 2), fill)
    xp[1:-1, 1:-1] = x
    return torch.stack([xp[1 - dj:1 - dj + B, 1 - dk:1 - dk + C]
                        for dj, dk in _SHIFTS])


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


def _sweep_axis(phi, tid, tri_verts, pos_axes, axis, reverse):
    """One directional plane scan along `axis` over (ni, nj, nk) phi / tid:
    plane a takes its candidates from plane a - 1 as already updated (a + 1
    when `reverse`); the first plane is kept."""
    out_phi = phi.movedim(axis, 0).contiguous()
    out_tid = tid.movedim(axis, 0).contiguous()
    nA, B, C = out_phi.shape
    other = [a for a in range(3) if a != axis]
    # in-plane world positions, the scanned axis' coordinate added per plane
    gx0 = torch.zeros((B, C, 3), dtype=torch.float32, device=phi.device)
    gx0[..., other[0]] = pos_axes[other[0]][:, None]
    gx0[..., other[1]] = pos_axes[other[1]][None, :]
    onehot = torch.zeros(3, dtype=torch.float32, device=phi.device)
    onehot[axis] = 1.0
    plane_pos = pos_axes[axis][:, None] * onehot  # (nA, 3): exact
    order = range(nA - 1, -1, -1) if reverse else range(nA)
    order = list(order)
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


def _axis_min_neighbors(phi):
    """Per axis, the smaller of each cell's two face neighbours, +inf
    beyond the grid."""
    mins = []
    for axis in range(3):
        pad = [0, 0] * 3
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
        ext = F.pad(phi[None], pad, value=float("inf"))[0]
        n = phi.shape[axis]
        mins.append(torch.minimum(ext.narrow(axis, 0, n),
                                  ext.narrow(axis, 2, n)))
    return mins


def _sort3(x, y, z):
    """Elementwise ascending sort of three tensors, by min and max (every
    output is one of the inputs, so the values are exactly a sort's)."""
    lo, hi = torch.minimum(x, y), torch.maximum(x, y)
    return (torch.minimum(lo, z), torch.maximum(lo, torch.minimum(hi, z)),
            torch.maximum(hi, z))


def eikonal_far_field(phi, frozen, dx: float, num_iters: int):
    """`num_iters` Jacobi iterations of |grad phi| = 1 outside `frozen`
    (fast_sweep_eikonal_kernel, gpu_lib/makelevelset3_gpu.cu:487-551): the
    axis-wise minimum neighbours sorted a <= b <= c, the 1D update a + dx
    where it does not exceed b, else the 2D update where it does not exceed
    c, else the 3D one; a cell with no finite neighbour keeps its value.
    phi (ni, nj, nk) float32, frozen bool, dx a float32-representable
    float."""
    dx32 = np.float32(dx)
    two_dx2 = float(np.float32(2.0) * dx32 * dx32)  # 2.0 * dx * dx in f32
    dx2 = float(dx32 * dx32)
    # a tensor divisor: PyTorch's CUDA kernels multiply by the reciprocal
    # of a Python scalar divisor, which rounds differently from a / 3
    three = phi.new_tensor(3.0)
    for _ in range(num_iters):
        a, b, c = _sort3(*_axis_min_neighbors(phi))
        x1 = a + float(dx32)
        ab = a - b
        s2 = two_dx2 - ab * ab
        x2 = 0.5 * (a + b + sqrt_f32(torch.clamp(s2, min=0.0)))
        ss = a + b + c
        s3 = ss * ss - 3.0 * (a * a + b * b + c * c - dx2)
        x3 = (ss + sqrt_f32(torch.clamp(s3, min=0.0))) / three
        upd = torch.where(x1 <= b, x1, torch.where(x2 <= c, x2, x3))
        upd = torch.where(torch.isfinite(a), upd, phi)  # isolated: keep
        phi = torch.where(frozen, phi, torch.minimum(phi, upd))
    return phi
