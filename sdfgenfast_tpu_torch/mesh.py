"""Triangle-mesh container.

Mirrors the reference's mesh representation — vertex list (N,3) float32 +
triangle index list (M,3) uint32 with bbox tracking (the
``std::vector<Vec3f>``/``std::vector<Vec3ui>`` pair threaded through
``common/mesh_io.h:36-85`` and ``cpu_lib/makelevelset3.h:39-41``) — as a
NumPy-first dataclass that converts cleanly to torch tensors. Copy of
``sdfgenfast_tpu/mesh.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Mesh:
    """verts: (N, 3) float32 world-space positions; tris: (M, 3) uint32 indices."""

    verts: np.ndarray
    tris: np.ndarray

    def __post_init__(self):
        self.verts = np.ascontiguousarray(self.verts, dtype=np.float32)
        self.tris = np.ascontiguousarray(self.tris, dtype=np.uint32)
        if self.verts.ndim != 2 or self.verts.shape[1] != 3:
            raise ValueError(f"verts must have shape (N, 3), got {self.verts.shape}")
        if self.tris.ndim != 2 or self.tris.shape[1] != 3:
            raise ValueError(f"tris must have shape (M, 3), got {self.tris.shape}")

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @property
    def is_empty(self) -> bool:
        return self.num_verts == 0 or self.num_tris == 0

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(min, max) corner of the axis-aligned bounding box, float32."""
        if self.num_verts == 0:
            raise ValueError("empty mesh has no bounds")
        return self.verts.min(axis=0), self.verts.max(axis=0)

    def validate_indices(self) -> None:
        if self.num_tris and int(self.tris.max()) >= self.num_verts:
            raise ValueError(
                f"triangle index {int(self.tris.max())} out of range for "
                f"{self.num_verts} vertices"
            )


def box_mesh(size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)) -> Mesh:
    """An axis-aligned box with 12 triangles, outward-oriented.

    Procedural stand-in for the reference's bundled 3x4x5 box resources
    (``tests/resources/``) — generated, not copied.
    """
    sx, sy, sz = size
    ox, oy, oz = origin
    corners = np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
            [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
        ],
        dtype=np.float32,
    )
    verts = corners * np.array([sx, sy, sz], np.float32) + np.array([ox, oy, oz], np.float32)
    # 12 triangles, CCW seen from outside.
    tris = np.array(
        [
            [0, 2, 1], [1, 2, 3],  # z = 0 face (normal -z)
            [4, 5, 6], [5, 7, 6],  # z = 1 face (normal +z)
            [0, 1, 4], [1, 5, 4],  # y = 0 face (normal -y)
            [2, 6, 3], [3, 6, 7],  # y = 1 face (normal +y)
            [0, 4, 2], [2, 4, 6],  # x = 0 face (normal -x)
            [1, 3, 5], [3, 7, 5],  # x = 1 face (normal +x)
        ],
        dtype=np.uint32,
    )
    return Mesh(verts, tris)


def icosphere(subdivisions: int = 2, radius: float = 1.0, center=(0.0, 0.0, 0.0)) -> Mesh:
    """Subdivided icosahedron — a closed, curved test mesh (1280 tris at
    subdivisions=3, ~80k at 6) whose exact SDF near the surface is ~|r|-radius."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts[0])
    tris = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_tris = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in tris:
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_tris += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        tris = np.array(new_tris, dtype=np.int64)
    verts = verts * radius + np.asarray(center, np.float64)
    return Mesh(verts.astype(np.float32), tris.astype(np.uint32))


def torus_mesh(nu: int = 224, nv: int = 224, R: float = 1.0, r: float = 0.4,
               center=(0.0, 0.0, 0.0)) -> Mesh:
    """Closed triangulated torus with 2*nu*nv triangles (nu=nv=224 gives the
    ~100k-triangle flagship benchmark mesh of BASELINE.json's north star).

    Parametric (R + r cos v)(cos u, sin u, 0) + (0, 0, r sin v), CCW winding
    with outward normals (watertight, genus 1 — a richer medial structure
    than the icospheres)."""
    u = np.arange(nu, dtype=np.float64) * (2.0 * np.pi / nu)
    v = np.arange(nv, dtype=np.float64) * (2.0 * np.pi / nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # (nu, nv)
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    verts += np.asarray(center, np.float32)

    iu = np.arange(nu)[:, None]
    iv = np.arange(nv)[None, :]
    a = (iu * nv + iv).ravel()
    b = (((iu + 1) % nu) * nv + iv).ravel()
    c = (iu * nv + (iv + 1) % nv).ravel()
    d = (((iu + 1) % nu) * nv + (iv + 1) % nv).ravel()
    tris = np.concatenate(
        [np.stack([a, b, d], axis=-1), np.stack([a, d, c], axis=-1)], axis=0
    ).astype(np.uint32)
    return Mesh(verts, tris)
