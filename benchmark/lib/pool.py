"""Meshes made from the seed: the configuration's mesh moved inside its
grid, and the vertex offsets of a fitting target.

Every mesh of a pool has the configuration's triangles and sits on the
configuration's grid (sized once from the nominal mesh), so every seed
gives the same work in another arrangement: where the configuration allows
it, a rotation about the mesh's centre and an inward radial displacement
of each vertex of at most `radial_inward_cells` cells, towards the centre;
then a translation towards the grid's origin of a tenth of
`translate_cells` to `translate_cells` cells on each axis. Mode 2a puts
the nominal mesh's far faces on the grid's last cells (or up to half a
cell past them, where it rounds an axis's count), so a translation that
way keeps every mesh within the grid's cells or as close to them as the
nominal mesh.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one use of the seed (any whole number >= 0)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def rotation(r: np.random.Generator) -> np.ndarray:
    """A uniformly drawn rotation matrix (QR of a Gaussian matrix)."""
    q, rr = np.linalg.qr(r.normal(size=(3, 3)))
    q = q * np.sign(np.diag(rr))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def jittered(verts, dx: float, r: np.random.Generator, *,
             translate_cells: float, rotate: bool,
             radial_inward_cells: float) -> np.ndarray:
    """One mesh of a pool: float32 vertices."""
    v = verts.astype(np.float64)
    centre = (v.min(axis=0) + v.max(axis=0)) / 2
    v = v - centre
    if rotate:
        v = v @ rotation(r).T
    if radial_inward_cells > 0:
        norm = np.linalg.norm(v, axis=1, keepdims=True)
        shrink = r.uniform(0.0, radial_inward_cells * dx, size=(len(v), 1))
        v = v * np.maximum(norm - shrink, 0.0) / np.maximum(norm, 1e-30)
    shift = -r.uniform(translate_cells / 10, translate_cells, size=3) * dx
    return (v + centre + shift).astype(np.float32)


def pool(verts, dx: float, size: int, seed: int, jitter: dict,
         translate_cells: float):
    r = rng(seed, 1)
    return [jittered(verts, dx, r, translate_cells=translate_cells,
                     rotate=bool(jitter.get("rotate", False)),
                     radial_inward_cells=float(
                         jitter.get("radial_inward_cells", 0.0)))
            for _ in range(size)]


def offsets(n: int, dx: float, cells: float, r: np.random.Generator):
    """(n, 3) offsets, each of length at most `cells` cells, uniform in the
    ball."""
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d * (cells * dx) * np.cbrt(r.uniform(size=(n, 1)))
