"""Cell-level vector distance transform (closest-point jump flooding), the
pyramid schedule and the chamfer relaxation, in plain torch.

Counterpart of the parts of ``sdfgenfast_tpu/ops/vdt.py`` that the binned
exact path runs (``vdt.py:71-147, 233-251, 329-574``). Propagating the
closest POINT (Danielsson's vector distance transform with jump-flooding
strides) keeps every propagated distance an exact distance to a point on
some mesh triangle, so the far field is an overestimate that shrinks as
O(dx^2 / depth).

State layout is channel-first (5, ni, nj, nk): closest point x/y/z, the
int32 triangle id BITCAST into a float32 channel (``Tensor.view``), and d2.
The id channel is only ever moved by selects and copies, never used in
arithmetic.

The rounds themselves run through ``ops/vdt_kernel.round_phase`` (kernel K3
on CUDA tensors, ``round_phase_reference`` here on CPU tensors); this
module's ``_jacobi_round`` is the plain round they are both held to.
Downsample, upsample, freeze and the sqrt stay plain torch ops, as the JAX
package leaves them to XLA outside its Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FAR",
    "PYRAMID_LEVEL_ROUNDS",
    "PYRAMID_COARSE_ROUNDS",
    "stride_ladder",
    "pyramid_level_shapes",
    "vdt_pyramid_far_field",
    "chamfer_relax",
    "chamfer_steps",
    "pack_state",
    "sqrt_f32",
    "unpack_tid",
]

_OFFSETS26 = np.array(
    [
        (a, b, c)
        for a in (-1, 0, 1)
        for b in (-1, 0, 1)
        for c in (-1, 0, 1)
        if (a, b, c) != (0, 0, 0)
    ],
    np.int32,
)

FAR = np.float32(3e18)
_BIG = float(np.float32(3e38))  # chamfer padding (vdt.chamfer_relax)


def sqrt_f32(x):
    """Correctly rounded float32 sqrt on every device. On CPU tensors
    torch.sqrt goes through MKL's vector math, which is not correctly
    rounded (and which values it misrounds depends on how the op is split
    over threads); a float64 sqrt rounded to float32 is. CUDA's sqrtf is
    IEEE already. A float64 tensor keeps its float64 sqrt."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def pack_state(cpx, cpy, cpz, tid, d2):
    """(5, ...) VDT state with the int32 id BITCAST into channel 3 (a value
    cast would round ids above 2^24)."""
    tbits = tid.to(torch.int32).view(torch.float32)
    return torch.stack([cpx, cpy, cpz, tbits, d2], dim=0)


def unpack_tid(channel):
    """Recover int32 triangle ids from the bitcast float32 state channel."""
    return channel.view(torch.int32)


def _dist2(px, py, pz, cx, cy, cz):
    dxp = px - cx
    dyp = py - cy
    dzp = pz - cz
    return dxp * dxp + dyp * dyp + dzp * dzp


def _merge(best, cand, cd2):
    """Adopt candidates with strictly smaller distance (all 5 channels)."""
    upd = torch.cat([cand[:4], cd2[None]], dim=0)
    better = cd2 < best[4]
    return torch.where(better[None], upd, best)


def _jacobi_round(state, px, py, pz, stride):
    """Jacobi round: ONE FAR-pad of the round-start state + 26 shifted
    candidate reads merged in _OFFSETS26 order. state: (5, ni, nj, nk).
    FAR donors never win (their d2 equals an unseeded cell's own), so the
    padding is exactly the kernel's "donors outside the grid do not exist"."""
    _, ni, nj, nk = state.shape
    s = stride
    ext = F.pad(state, (s, s, s, s, s, s), value=float(FAR))
    best = state
    for oa, ob, oc in _OFFSETS26.tolist():
        i0, j0, k0 = s + oa * s, s + ob * s, s + oc * s
        cand = ext[:, i0:i0 + ni, j0:j0 + nj, k0:k0 + nk]
        cd2 = _dist2(px, py, pz, cand[0], cand[1], cand[2])
        best = _merge(best, cand, cd2)
    return best


def stride_ladder(max_dim: int, extra_rounds: int = 2):
    """The jump-flood stride schedule: max_dim/2, /4, .., 1, then
    `extra_rounds` stride-1 polish rounds. (The JAX package's `max_hop` cap
    belongs to the capped ladder, which is not ported.)"""
    s = 1
    while s * 2 < max_dim:
        s *= 2
    strides = []
    while s >= 1:
        strides.append(s)
        s //= 2
    return tuple(strides + [1] * extra_rounds)


# ---------------------------------------------------------------------------
# Pyramid (coarse-to-fine) VDT
# ---------------------------------------------------------------------------
#   1. min-downsample the seeded state by 2 per level until <= 48 cells
#      (at most two downsamples);
#   2. full jump-flood ladder at the coarsest level;
#   3. walk back down: upsample (parent closest points re-scored against the
#      fine cell positions, merged with the level's own seeds), then
#      short-stride Jacobi repair rounds;
#   4. extra stride-1 polish rounds at full resolution.

_COARSE_MAX = 48
_MAX_LEVELS = 3

PYRAMID_LEVEL_ROUNDS = (8, 4, 2, 2, 1)
PYRAMID_COARSE_ROUNDS = (8, 4, 2, 1, 1)


def pyramid_level_shapes(grid_shape):
    """Level 0 is the grid itself; each level halves (ceil) until
    <= _COARSE_MAX or _MAX_LEVELS levels exist."""
    shapes = [tuple(grid_shape)]
    while (max(shapes[-1]) > _COARSE_MAX and len(shapes) < _MAX_LEVELS):
        shapes.append(tuple(-(-d // 2) for d in shapes[-1]))
    return shapes


def _axis_pos(n, scale, dx, device):
    """f32(index * scale) * dx along one axis (exact fine-grid positions)."""
    return (torch.arange(n, dtype=torch.int32, device=device) * scale
            ).to(torch.float32) * dx


def _level_pos_axes(shape, dx, scale: int, device):
    """World coords of a pyramid level: level cell I sits at fine index
    I * scale, broadcastable as (ni,1,1), (1,nj,1), (1,1,nk)."""
    ni, nj, nk = shape
    return (_axis_pos(ni, scale, dx, device)[:, None, None],
            _axis_pos(nj, scale, dx, device)[None, :, None],
            _axis_pos(nk, scale, dx, device)[None, None, :])


def _downsample2(state, dx, fine_scale):
    """Factor-2 min-downsample as three axis-wise pairwise tournaments (a
    GREEDY approximation of the 8-child argmin; every surviving cp is still
    a real surface point). Each pass re-scores both children against the
    position that is coarse in the axes merged so far and fine in the rest."""
    dev = state.device
    _, ni, nj, nk = state.shape
    if ni % 2 or nj % 2 or nk % 2:
        state = F.pad(state, (0, nk % 2, 0, nj % 2, 0, ni % 2),
                      value=float(FAR))

    def pos(n, scale, which):
        shape = [1, 1, 1]
        shape[which] = n
        return _axis_pos(n, scale, dx, dev).reshape(shape)

    def pair_merge(a, b, p):
        # keep the child whose cp is closer to the even-child position
        da = _dist2(*p, a[0], a[1], a[2])
        best = torch.cat([a[:4], da[None]], dim=0)
        db = _dist2(*p, b[0], b[1], b[2])
        return _merge(best, b, db)

    f, c = fine_scale, 2 * fine_scale
    _, ni_p, nj_p, nk_p = state.shape
    ni2, nj2, nk2 = ni_p // 2, nj_p // 2, nk_p // 2
    state = pair_merge(state[:, 0::2], state[:, 1::2],
                       (pos(ni2, c, 0), pos(nj_p, f, 1), pos(nk_p, f, 2)))
    state = pair_merge(state[:, :, 0::2], state[:, :, 1::2],
                       (pos(ni2, c, 0), pos(nj2, c, 1), pos(nk_p, f, 2)))
    pairs = state.reshape(5, ni2, nj2, nk2, 2)
    return pair_merge(pairs[..., 0], pairs[..., 1],
                      (pos(ni2, c, 0), pos(nj2, c, 1), pos(nk2, c, 2)))


def _upsample_merge(coarse, fine, px, py, pz):
    """Adopt the coarse parent's closest point wherever it beats the fine
    state (re-scored against the fine cell positions)."""
    _, ni, nj, nk = fine.shape
    parent = (coarse.repeat_interleave(2, dim=1)
              .repeat_interleave(2, dim=2)
              .repeat_interleave(2, dim=3))[:, :ni, :nj, :nk]
    cd2 = _dist2(px, py, pz, parent[0], parent[1], parent[2])
    return _merge(fine, parent, cd2)


def vdt_pyramid_far_field(
    cpx, cpy, cpz,  # (ni, nj, nk) f32 seed closest points (grid-local), FAR empty
    tid,  # (ni, nj, nk) int32 seed ids, -1 empty
    phi_seed,  # (ni, nj, nk) f32 band distances (upper if unseeded)
    dx: float,  # float32-representable cell size
    *,
    freeze_mask,  # bool: cells whose phi_seed is provably exact
    extra_polish: int,  # stride-1 rounds after the finest level's repair
    phase,  # (state, dx, strides, scale) -> state: vdt_kernel.round_phase
):
    """Coarse-to-fine closest-point transform. Returns (phi, tid): frozen
    cells keep their exact band values and ids, every other cell takes
    min(|p - cp|, phi_seed) and the propagated id.

    `phase` runs a sequence of Jacobi rounds at one level; the pipeline
    passes ``vdt_kernel.round_phase`` (kernel K3 on CUDA). Unlike the JAX
    package, the coarsest level's strides above 8 go through `phase` too:
    the kernel takes every stride, and the rounds are the same function."""
    ni, nj, nk = cpx.shape
    dev = cpx.device
    px, py, pz = _level_pos_axes((ni, nj, nk), dx, 1, dev)
    d2 = _dist2(px, py, pz, cpx, cpy, cpz)
    state = pack_state(cpx, cpy, cpz, tid, d2)

    levels = [(state, (px, py, pz), 1)]
    for _ in range(len(pyramid_level_shapes((ni, nj, nk))) - 1):
        prev, _, scale = levels[-1]
        shape2 = tuple(-(-d // 2) for d in prev.shape[1:])
        pos2 = _level_pos_axes(shape2, dx, scale * 2, dev)
        levels.append((_downsample2(prev, dx, scale), pos2, scale * 2))

    # coarsest level: full jump-flood ladder (the state is tiny)
    s, _, scale_c = levels[-1]
    s = phase(s, dx, stride_ladder(max(s.shape[1:]), extra_rounds=1), scale_c)

    # descend: upsample + short-stride repair rounds
    for lvl in range(len(levels) - 2, -1, -1):
        fine, pos, scale_l = levels[lvl]
        s = _upsample_merge(s, fine, *pos)
        rounds = PYRAMID_COARSE_ROUNDS if lvl > 0 else (
            PYRAMID_LEVEL_ROUNDS + (1,) * extra_polish)
        s = phase(s, dx, rounds, scale_l)

    phi = sqrt_f32(torch.clamp(s[4], min=0.0))
    out_tid = unpack_tid(s[3])
    return (
        torch.where(freeze_mask, phi_seed, torch.minimum(phi, phi_seed)),
        torch.where(freeze_mask, tid, out_tid),
    )


def chamfer_steps(dx: float):
    """float32 step lengths |o| * dx for |o|^2 = 1, 2, 3, rounded like
    vdt.chamfer_relax: f32 sqrt, then an f32 product with dx."""
    dx32 = np.float32(dx)
    return tuple(float(np.sqrt(np.float32(n)) * dx32) for n in (1, 2, 3))


def chamfer_relax(phi, dx: float, passes: int = 2):
    """Lipschitz relaxation of an everywhere->=true unsigned distance field:
    phi_new(p) = min(phi(p), min_o phi(p+o) + |o|*dx) over the 26-offset
    stencil, cells outside the grid read as 3e38. Monotone non-increasing and
    never below the true distance (triangle inequality)."""
    ni, nj, nk = phi.shape
    steps = chamfer_steps(dx)
    for _ in range(passes):
        ext = F.pad(phi, (1, 1, 1, 1, 1, 1), value=_BIG)
        acc = phi
        for oa, ob, oc in _OFFSETS26.tolist():
            nb = ext[1 + oa:1 + oa + ni, 1 + ob:1 + ob + nj, 1 + oc:1 + oc + nk]
            acc = torch.minimum(acc, nb + steps[oa * oa + ob * ob + oc * oc - 1])
        phi = acc
    return phi
