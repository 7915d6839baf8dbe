"""The plain reference against a brute force of its own and a ray parity,
on tiny meshes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.meshes import box36, icosphere
from benchmark.reference import sdf as ref

MESHES = {"icosphere1": lambda: icosphere.make(1, 1.0),
          "icosphere2": lambda: icosphere.make(2, 0.8),
          "box36": lambda: box36.make((0.6, 0.8, 1.0), (-0.3, -0.4, -0.5))}


def _tri(name, dtype=torch.float64):
    v, t = MESHES[name]()
    return ref.triangles(torch.tensor(v, dtype=dtype),
                         torch.tensor(t.astype(np.int64)))


def _surface_samples(tri: np.ndarray, n: int = 40):
    """Points of a barycentric lattice of every triangle."""
    u = np.linspace(0.0, 1.0, n)
    uu, vv = np.meshgrid(u, u)
    keep = uu + vv <= 1
    uu, vv = uu[keep], vv[keep]
    ab, ac = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    pts = (tri[:, 0, None] + ab[:, None] * uu[None, :, None]
           + ac[:, None] * vv[None, :, None])
    return pts.reshape(-1, 3)


def _ray_parity(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Inside by the parity of a ray's crossings (Moller-Trumbore, along a
    direction no face or edge of these meshes lies in)."""
    d = np.array([0.5773, 0.5811, 0.5736])
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    e1, e2 = b - a, c - a
    h = np.cross(d, e2)
    det = np.einsum("ij,ij->i", e1, h)
    inside = []
    for q in p:
        s = q - a
        u = np.einsum("ij,ij->i", s, h) / det
        qv = np.cross(s, e1)
        v = qv @ d / det
        t = np.einsum("ij,ij->i", e2, qv) / det
        hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        inside.append(hit.sum() % 2 == 1)
    return np.array(inside)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_distance_matches_brute_force(name):
    tri = _tri(name)
    rng = np.random.default_rng(7)
    pts = torch.tensor(rng.uniform(-1.4, 1.4, size=(300, 3)))
    d2, idx = ref.closest(pts, tri)
    got = torch.sqrt(d2).numpy()
    samples = _surface_samples(tri.numpy())
    brute = np.sqrt(((pts.numpy()[:, None] - samples[None]) ** 2)
                    .sum(-1).min(1))
    # the lattice's points lie on the mesh: never nearer than the exact
    # distance, and within the lattice's spacing of it
    assert (brute >= got - 1e-12).all()
    assert (brute - got).max() < 0.02
    own = torch.sqrt(ref.dist2(
        ref._split(pts), *(ref._split(tri[idx, k]) for k in range(3))))
    assert torch.allclose(own, torch.sqrt(d2), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sign_matches_ray_parity(name):
    tri = _tri(name)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.3, 1.3, size=(400, 3))
    phi, _ = ref.signed_distance(torch.tensor(pts), tri)
    parity = _ray_parity(pts, tri.numpy())
    away = np.abs(phi.numpy()) > 1e-6
    assert away.sum() > 350
    assert np.array_equal((phi.numpy() < 0)[away], parity[away])
    assert parity.any() and not parity.all()


def test_exact_cases_of_one_triangle():
    tri = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                       dtype=torch.float64)
    pts = torch.tensor([[0.25, 0.25, 2.0],   # over the face
                        [-1.0, -1.0, 0.0],   # vertex a
                        [0.5, -2.0, 0.0],    # edge ab
                        [1.0, 1.0, 0.0],     # edge bc
                        [3.0, -1.0, 1.0]],   # vertex b
                       dtype=torch.float64)
    d2, _ = ref.closest(pts, tri)
    want = [4.0, 2.0, 4.0, 0.5, 6.0]
    assert torch.allclose(d2, torch.tensor(want, dtype=torch.float64))


def test_grid_points_and_gradient():
    pts = ref.grid_points((-1.0, -2.0, 0.5), 0.25, (4, 5, 6),
                          torch.tensor([0, 1, 6, 30, 119]))
    want = [[-1, -2, 0.5], [-1, -2, 0.75], [-1, -1.75, 0.5],
            [-0.75, -2, 0.5], [-0.25, -1, 1.75]]
    assert torch.allclose(pts, torch.tensor(want, dtype=torch.float64))
    tri = _tri("icosphere1")[:4].clone().requires_grad_(True)
    p = torch.tensor([[0.1, 0.2, 2.0]] * 4, dtype=torch.float64)
    d = ref.distance_to(p, tri)
    (g,) = torch.autograd.grad(d.sum(), tri)
    eps = 1e-6
    num = torch.zeros_like(tri)
    for i in range(4):
        for k in range(3):
            for c in range(3):
                t2 = tri.detach().clone()
                t2[i, k, c] += eps
                num[i, k, c] = (ref.distance_to(p, t2).sum()
                                - d.detach().sum()) / eps
    assert torch.allclose(g, num, atol=1e-5)
