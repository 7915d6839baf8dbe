"""Subdivided icosahedron on a sphere: 20 * 4**subdivisions triangles
(81,920 at 6), outward-oriented, vertices on the sphere of `radius`.

Frozen copy of ``sdfgenfast_tpu_torch.mesh.icosphere``: the same vertex and
triangle order, bit for bit."""

from __future__ import annotations

import numpy as np


def make(subdivisions: int = 2, radius: float = 1.0):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    verts /= np.linalg.norm(verts[0])
    tris = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        new_tris = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                edge_mid[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return edge_mid[key]

        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tris += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        tris = np.array(new_tris, dtype=np.int64)
    verts = verts * radius
    return verts.astype(np.float32), tris.astype(np.uint32)
