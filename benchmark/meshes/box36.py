"""The upstream benchmark's box: an axis-aligned box of `size` at `origin`
(12 triangles, outward-oriented), each face triangle split 1 -> 3 at its
centroid, 36 triangles.

Frozen copy of ``sdfgenfast_tpu_torch.mesh.box_mesh`` and
``testing.box36``: the same vertex and triangle order, bit for bit."""

from __future__ import annotations

import numpy as np


def make(size=(3.0, 4.0, 5.0), origin=(-1.0, -1.0, -1.0)):
    corners = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
                       dtype=np.float32)
    verts = (corners * np.asarray(size, np.float32)
             + np.asarray(origin, np.float32))
    tris = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6],
                     [0, 1, 4], [1, 5, 4], [2, 6, 3], [3, 6, 7],
                     [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]],
                    dtype=np.uint32)
    cent = verts[tris].mean(axis=1).astype(np.float32)
    nv = len(verts)
    split = [(a, b, nv + i) for i, (a0, b0, c0) in enumerate(tris)
             for a, b in ((a0, b0), (b0, c0), (c0, a0))]
    return (np.concatenate([verts, cent]).astype(np.float32),
            np.asarray(split, np.uint32))
