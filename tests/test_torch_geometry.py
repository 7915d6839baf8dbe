"""The port's ``point_triangle_distance`` and ``closest_point_weights``
(``sdfgenfast_tpu_torch/ops/geometry.py``) against the JAX package's, on
the cases of tests/test_geometry.py: op by op (``jax.disable_jit``) the
values are bit-equal, and against the jitted functions and the float64
oracle within the tolerances that file holds the JAX functions to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfgenfast_tpu.ops import geometry as jgeom
from sdfgenfast_tpu_torch.ops import geometry as pgeom
from oracle import point_triangle_distance_np

torch.set_num_threads(1)


def _rand(n, rng, scale=2.0):
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


def _cases():
    """tests/test_geometry.py's inputs: 4096 random triangles (seeds 42 and
    7) and its degenerate ones."""
    out = {}
    for seed in (42, 7):
        rng = np.random.default_rng(seed)
        out[f"random{seed}"] = tuple(_rand(4096, rng) for _ in range(4))
    x0 = np.asarray([[0.0, 1.0, 0.0]], np.float32)
    x1 = np.asarray([[0.0, 0.0, 0.0]], np.float32)
    x2 = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    out["collinear"] = (x0, x1, x2, x2)
    out["point"] = (x0, x1, x1, x1)
    return out


CASES = _cases()


def _port(fn, args):
    r = fn(*(torch.from_numpy(a) for a in args))
    return tuple(x.numpy() for x in r) if isinstance(r, tuple) else r.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_point_triangle_distance_matches_jax(case):
    args = CASES[case]
    got = _port(pgeom.point_triangle_distance, args)
    with jax.disable_jit():
        eager = np.asarray(jgeom.point_triangle_distance(
            *(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got.view(np.int32), eager.view(np.int32))
    jitted = np.asarray(jax.jit(jgeom.point_triangle_distance)(
        *(jnp.asarray(a) for a in args)))
    # jitted JAX contracts FMAs: held to test_geometry.py's oracle bars
    np.testing.assert_allclose(got, jitted, rtol=2e-5, atol=2e-6)
    exact = point_triangle_distance_np(*(a.astype(np.float64) for a in args))
    np.testing.assert_allclose(got, exact, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_point_weights_match_jax(case):
    args = CASES[case]
    got = _port(pgeom.closest_point_weights, args)
    with jax.disable_jit():
        eager = [np.asarray(w) for w in jgeom.closest_point_weights(
            *(jnp.asarray(a) for a in args))]
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g.view(np.int32), e.view(np.int32))
    jitted = [np.asarray(w) for w in jax.jit(jgeom.closest_point_weights)(
        *(jnp.asarray(a) for a in args))]
    for g, j in zip(got, jitted):
        np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-5)
    # tests/test_geometry.py's bars: the weights sum to one, none negative,
    # and their point is at the triangle's distance
    w1, w2, w3 = got
    np.testing.assert_allclose(w1 + w2 + w3, 1.0, atol=1e-5)
    assert (w1 >= -1e-6).all() and (w2 >= -1e-6).all() and (w3 >= -1e-6).all()
    x0, x1, x2, x3 = args
    c = w1[:, None] * x1 + w2[:, None] * x2 + w3[:, None] * x3
    d = np.linalg.norm(x0 - c, axis=-1)
    ref = _port(pgeom.point_triangle_distance, args)
    np.testing.assert_allclose(d, ref, rtol=1e-4, atol=1e-5)


def test_degenerate_distances_are_the_reference_values():
    """tests/test_geometry.py::test_degenerate_triangle: with x2 == x3 the
    closest point is x3 (sqrt 2), with one repeated point 1."""
    x0, x1, x2, _ = CASES["collinear"]
    assert np.isfinite(CASES["collinear"][0]).all()
    np.testing.assert_allclose(
        _port(pgeom.point_triangle_distance, CASES["collinear"]),
        np.sqrt(2.0), rtol=1e-6)
    np.testing.assert_allclose(
        _port(pgeom.point_triangle_distance, CASES["point"]), 1.0, rtol=1e-6)
