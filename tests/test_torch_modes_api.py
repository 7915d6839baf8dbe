"""The non-default far fields through the port's public entry points on
the CPU: ``generate_sdf(backend="cpu", far_field=...)``,
``generate_sdf_batch`` and the vertex gradient of
``models.SDFGenerator.loss`` in propagate and eikonal mode, against the
JAX model's ``jax.grad`` (1e-4 of the largest gradient,
tests/test_torch_grad.py's bar under jit) on tests/test_torch_grad.py's
problem. Propagate's gradient flows through every cell's id, eikonal's
through the seeded band only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from oracle import brute_force_sdf
from sdfgenfast_tpu.mesh import icosphere as j_icosphere
from sdfgenfast_tpu.models import SDFGenerator as JGenerator
from sdfgenfast_tpu_torch.models import SDFGenerator
from test_torch_modes import _box, _carry

CPU = torch.device("cpu")

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("far_field", ["propagate", "eikonal"])
def test_generate_sdf_cpu_far_field(far_field):
    """The public entry point on the CPU twins, far_field by its argument:
    bit-equal to make_level_set3 with the port's own binning (the box:
    12 triangles, binned in these modes)."""
    jmesh, jgrid = _box()
    mesh = P.Mesh(jmesh.verts, jmesh.tris)
    grid = P.GridSpec(jgrid.origin, jgrid.dx, jgrid.shape)
    got = P.generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                         *grid.shape, backend="cpu", far_field=far_field)
    want = P.make_level_set3(mesh, grid, P.SDFConfig(far_field=far_field),
                             device=CPU).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = brute_force_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                          grid.shape)
    assert np.abs(np.abs(got) - np.abs(ref)).max() < 2 * grid.dx


@pytest.mark.parametrize("knobs", [dict(vdt_max_hop=4),
                                   dict(vdt_extra_rounds=2),
                                   dict(tile_shape=(4, 4, 16))],
                         ids=["capped", "flat", "tiles4x4x16"])
def test_generate_sdf_cpu_schedule_knobs(knobs):
    """The schedule knobs reach the pipeline through `config`; exact_band
    and far_field come from their own arguments."""
    jmesh, jgrid = _box()
    mesh = P.Mesh(jmesh.verts, jmesh.tris)
    grid = P.GridSpec(jgrid.origin, jgrid.dx, jgrid.shape)
    cfg = P.SDFConfig(dense_max_tris=0, far_field="eikonal", **knobs)
    got = P.generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                         *grid.shape, backend="cpu", config=cfg)
    want = P.make_level_set3(mesh, grid, P.SDFConfig(dense_max_tris=0,
                                                     **knobs),
                             device=CPU).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    sdf, _ = P.generate_from_mesh(mesh.verts, mesh.tris, nx=10,
                                  backend="cpu", config=cfg)
    assert np.isfinite(sdf).all()


def test_batch_propagate_equals_single_calls():
    """generate_sdf_batch in propagate mode (one host sync a pass, so no
    overlap) gives each single call's field."""
    jmesh, jgrid = _box()
    meshes = [(jmesh.verts, jmesh.tris),
              (jmesh.verts * np.float32(0.9), jmesh.tris)]
    got = P.generate_sdf_batch(meshes, jgrid.origin, jgrid.dx, *jgrid.shape,
                               backend="cpu", far_field="propagate")
    for (v, t), phi in zip(meshes, got):
        want = P.generate_sdf(v, t, jgrid.origin, jgrid.dx, *jgrid.shape,
                              backend="cpu", far_field="propagate")
        np.testing.assert_array_equal(phi.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("far_field", ["propagate", "eikonal"])
def test_sdf_generator_gradient_matches_jax(far_field):
    """The vertex gradient of the loss, on tests/test_torch_grad.py's
    problem."""
    m = j_icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
    g = J.GridSpec((-1.3, -1.3, -1.3), 2.6 / 16, (16, 16, 16))
    jcfg = J.SDFConfig(far_field=far_field)
    jmodel = JGenerator(m, g, jcfg)
    target = np.array(jmodel.forward(jnp.asarray(m.verts * np.float32(0.95))))
    jg = np.asarray(jax.grad(jmodel.loss)(jnp.asarray(m.verts),
                                          jnp.asarray(target)))

    pcfg = P.SDFConfig(far_field=far_field)
    pg = P.GridSpec(g.origin, g.dx, g.shape)
    model = SDFGenerator(P.Mesh(m.verts, m.tris), pg, pcfg, device=CPU,
                         binned=_carry(jmodel.binned, pg, pcfg))
    v = model.params.requires_grad_()
    loss = model.loss(v, torch.from_numpy(target))
    (grad,) = torch.autograd.grad(loss, v)
    grad = grad.numpy()
    # the loss against the float64 mean over JAX's field (the JAX loss's
    # own float32 sum reads ~2e-5 off it)
    jphi = np.asarray(jmodel.forward(jnp.asarray(m.verts)), np.float64)
    np.testing.assert_allclose(float(loss.detach()),
                               np.mean((jphi - target) ** 2), rtol=1e-5)
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    scale = float(np.abs(jg).max())
    assert np.abs(grad - jg).max() <= 1e-4 * scale


@pytest.mark.parametrize("far_field", ["propagate", "eikonal"])
def test_gradient_beyond_the_band(far_field):
    """A loss on the cells beyond the seeded band (the corner tiles of this
    grid hold no candidate): the eikonal far field carries no gradient,
    propagate's recomputed distances do."""
    mesh = P.icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
    grid = P.GridSpec((-3.25, -3.25, -3.25), 2.6 / 16, (40, 40, 40))
    cfg = P.SDFConfig(far_field=far_field)
    binned = P.bin_mesh(mesh, grid, cfg)
    _, band_tid = P.make_level_set3(mesh, grid, P.SDFConfig(
        far_field="eikonal"), binned, device=CPU, return_tid=True)
    far = torch.from_numpy((band_tid.numpy() < 0).astype(np.float32))
    assert 0 < float(far.mean()) < 1
    v = torch.from_numpy(mesh.verts.copy()).requires_grad_()
    out = P.make_level_set3(mesh, grid, cfg, binned, device=CPU, verts=v)
    (g,) = torch.autograd.grad((out * far).sum(), v, retain_graph=True)
    assert bool((g == 0).all()) == (far_field == "eikonal")
    # and the band's cells carry it in both modes
    (g,) = torch.autograd.grad((out * (1 - far)).sum(), v)
    assert bool((g != 0).any())
