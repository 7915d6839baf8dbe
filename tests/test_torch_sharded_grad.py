"""Vertex gradients through the port's sharded pipeline on the CPU
(``["cpu"] * 8`` as a (2, 4) mesh), against the port's single-device
gradient and the JAX package's (8 virtual CPU devices, tests/conftest.py).

Against the port's single-device gradient, the bars of
tests/test_sharded.py's gradient tests:

- the asymmetric icosphere(1) at 64^3: agreement everywhere but < 3% of
  the components (|diff| <= 1e-4 + 5e-3 |g|) and a median difference
  below 1e-4 of the largest gradient;
- icosphere(1) at 16^3, dense and binned: rtol 5e-3, atol 1e-4.

Against JAX: at 16^3 JAX's sharded gradient, end to end, at the same bars.
At 64^3 the end-to-end bars do not hold for the port's single-device path
either: 5.3% of the far field's ids differ from JAX's (the pyramids'
near-tie flips), and jitted JAX's gradient is 7.0e-3 of the largest from
its own op-by-op gradient on equal ids (FMA contraction summed over 262,144
randomly weighted cells). So at 64^3 the sharded gradient is held to
JAX's recompute stage run op by op (``jax.disable_jit()``) on the sharded
run's own ids and parity, at tests/test_torch_grad.py's op-by-op bar, 2e-6
of the largest gradient.

Each shard's R1b sums its own cells, and autograd sums the shards'
gradients on the vertices, so the sharded gradient differs from the
single-device one by float32 rounding; two sharded runs are bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sdfgenfast_tpu as J
from sdfgenfast_tpu import pipeline as jpipe
from sdfgenfast_tpu.parallel import sharded as jsh
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch.ops import sign_kernel
from sdfgenfast_tpu_torch.parallel import sharded as psh

CPU = torch.device("cpu")
DIMS = (2, 4)

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _asymmetric_ico1():
    """tests/test_sharded.py's mesh: exact distance ties measure-zero."""
    m = P.icosphere(1, radius=0.9, center=(0.02, 0.01, -0.03))
    rng = np.random.default_rng(7)
    return P.Mesh((m.verts + rng.uniform(-0.02, 0.02, m.verts.shape)
                   ).astype(np.float32), m.tris)


CASES = {
    "ico1-64": (_asymmetric_ico1, ((-1.3,) * 3, 2.6 / 64, (64, 64, 64)),
                dict(tile2d_shape=(8, 8), dense_max_tris=0), 3),
    "ico1-16-dense": (
        lambda: P.icosphere(1, radius=0.9, center=(0.02, 0.01, -0.03)),
        ((-1.3,) * 3, 0.1625, (16, 16, 16)),
        dict(tile_shape=(8, 8, 4), tile2d_shape=(8, 4), dense_max_tris=1024,
             vdt_max_hop=4), 1),
    "ico1-16-binned": (
        lambda: P.icosphere(1, radius=0.9, center=(0.02, 0.01, -0.03)),
        ((-1.3,) * 3, 0.1625, (16, 16, 16)),
        dict(tile_shape=(8, 8, 4), tile2d_shape=(8, 4), dense_max_tris=0,
             vdt_max_hop=4), 1),
}


@pytest.fixture(scope="module", params=list(CASES))
def grads(request):
    make, (origin, dx, shape), knobs, seed = CASES[request.param]
    mesh = make()
    grid = P.GridSpec(origin, dx, shape)
    cfg = P.SDFConfig(**knobs)
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    sb = psh.bin_mesh_sharded(mesh, grid, DIMS, cfg)
    dm = psh.make_device_mesh([CPU] * 8, DIMS)

    def port(fn):
        v = torch.from_numpy(mesh.verts.copy()).requires_grad_()
        (fn(v) * torch.from_numpy(w)).sum().backward()
        return v.grad.numpy()

    sharded = [port(lambda v: psh.sharded_sdf(sb, dm, verts=v))
               for _ in range(2)]
    binned = P.bin_mesh(mesh, grid, cfg)
    single = port(lambda v: P.make_level_set3(mesh, grid, cfg, binned=binned,
                                              device=CPU, verts=v))
    jw = jnp.asarray(w)
    if request.param == "ico1-64":
        _, tid = psh.sharded_sdf(sb, dm, verts=mesh.verts, return_tid=True)
        parity = sign_kernel.parity_sign(torch.from_numpy(
            binned.parity_packed if binned.parity_packed is not None
            else binned.parity_crossings), shape[0]).numpy()

        def f(v):
            return jnp.sum(jpipe._recompute_stage(
                v[jnp.asarray(mesh.tris)], jnp.asarray(tid.numpy()),
                jnp.asarray(parity), jnp.asarray(origin, jnp.float32),
                jnp.float32(dx)) * jw)

        with jax.disable_jit():
            jgrad = np.asarray(jax.grad(f)(jnp.asarray(mesh.verts)))
    else:
        jsb = jsh.bin_mesh_sharded(J.Mesh(mesh.verts, mesh.tris),
                                   J.GridSpec(origin, dx, shape), DIMS,
                                   J.SDFConfig(**knobs))
        jdm = jsh.make_device_mesh(shape=DIMS)
        jgrad = np.asarray(jax.grad(
            lambda v: jnp.sum(jsh.sharded_sdf(jsb, jdm, verts=v) * jw))(
                jnp.asarray(mesh.verts)))
    return dict(name=request.param, sharded=sharded, single=single,
                jax=jgrad)


def _assert_bars(name, got, want):
    if name == "ico1-64":
        diff = np.abs(got - want)
        frac_bad = float((diff > 1e-4 + 5e-3 * np.abs(want)).mean())
        assert frac_bad < 0.03, f"{frac_bad:.3f} of components deviate"
        scale = max(np.abs(want).max(), 1e-6)
        assert float(np.median(diff)) < 1e-4 * scale
    else:
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


def test_sharded_gradient_runs_are_bit_equal(grads):
    a, b = grads["sharded"]
    assert np.abs(a).max() > 0
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_sharded_gradient_matches_single_device(grads):
    _assert_bars(grads["name"], grads["sharded"][0], grads["single"])


def test_sharded_gradient_matches_jax(grads):
    got, want = grads["sharded"][0], grads["jax"]
    if grads["name"] == "ico1-64":  # op by op, on the sharded run's ids
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    else:  # jax's sharded gradient, end to end
        _assert_bars(grads["name"], got, want)
