"""Hand-made inputs for checking the port's kernels against their twins.

Used by the CPU tests (``tests/test_torch_*.py``) and by ``chip_smoke.py``
on the card, so both hold a kernel to the same cases. Nothing on the
generation path imports this module."""

from __future__ import annotations

import numpy as np

from .mesh import Mesh, box_mesh
from .ops.band_kernel import CHUNK

__all__ = ["box36", "k2_segments"]


def box36():
    """The reference's 36-triangle benchmark box (``bench.py``): the 3x4x5
    box with each face triangle split 1->3 at its centroid."""
    m = box_mesh((3, 4, 5), (-1, -1, -1))
    cent = m.verts[m.tris].mean(axis=1).astype(np.float32)
    nv = len(m.verts)
    tris = [(a, b, nv + i) for i, (a0, b0, c0) in enumerate(m.tris)
            for a, b in ((a0, b0), (b0, c0), (c0, a0))]
    return Mesh(np.concatenate([m.verts, cent]), np.asarray(tris, np.uint32))


def k2_segments(tl, dx, tiles_dim, active, counts):
    """Hand-made K2 segments for (M, 3, 3) grid-local triangles `tl`: on
    distinct active tiles, the `counts[i]` triangles nearest tile
    active[i * len(active) // len(counts)], two zero-area ones added to the
    last (a point at the tile's centre and a segment from it, ids 0 and 1:
    the table is the zero-area rows, then `tl` as ids 2 .. M + 1, so they
    win the cells around the centre and the point wins the ties with the
    segment); the 40 triangles nearest the grid's far corner tile;
    each ascending, padded to a CHUNK multiple with the sentinel id M + 2;
    and a padded slot. Returns (tri9, pair, ids, off, cnt)."""
    T = int(np.prod(tiles_dim))
    _, ntj, ntk = tiles_dim
    M = len(tl)
    cen = tl.mean(axis=1)

    def centre(t):
        return (np.array([t // (ntj * ntk), (t // ntk) % ntj, t % ntk]) * 8
                + 3.5) * dx

    def nearest(t, n):
        d = np.linalg.norm(cen - centre(t), axis=1)
        return np.sort(np.argsort(d)[:n]) + 2

    picks = [int(active[i * len(active) // len(counts)])
             for i in range(len(counts))]
    segs = [(t, nearest(t, n)) for t, n in zip(picks, counts)]
    a = centre(picks[-1])
    b = a + np.array([2.0, 1.0, 0.0]) * dx
    zero = np.stack([np.stack([a, a, a]), np.stack([a, b, b])])
    segs[-1] = (picks[-1], np.concatenate([[0, 1], segs[-1][1]]))
    segs.append((T - 1, nearest(T - 1, 40)))
    if len({t for t, _ in segs}) != len(segs):
        raise AssertionError("hand-made K2 tiles are not distinct")
    pair, ids, off, cnt = [], [], [], []
    for t, c in segs:
        n = -(-len(c) // CHUNK) * CHUNK
        ids.append(t)
        off.append(len(pair))
        cnt.append(n)
        pair += list(c) + [M + 2] * (n - len(c))
    ids.append(T)  # a padded slot: no candidates, the junk row
    off.append(0)
    cnt.append(0)
    tri9 = np.concatenate([zero, tl]).astype(np.float32).reshape(-1, 9)
    return (tri9, *(np.asarray(a, np.int32) for a in (pair, ids, off, cnt)))
