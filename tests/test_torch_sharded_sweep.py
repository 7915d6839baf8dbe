"""The port's sharded ``far_field="eikonal"`` and ``"propagate"``
(``sdfgenfast_tpu_torch.parallel.sharded``) on the CPU: eight shards on
``["cpu"] * 8`` as (2, 4) and (1, 8) meshes, on the JAX package's cases
(tests/test_sharded.py ``TestShardedEikonal``, ``TestShardedPropagate``
and the device-sign eikonal), beside the JAX package on its eight virtual
CPU devices (tests/conftest.py).

Bars and why:

- Every plane update and Jacobi iteration of a shard equals the
  single-device one on its cells (the same candidates in the same order,
  the global positions and upper bound), so the sharded field and ids
  equal ``make_level_set3``'s bit for bit, and propagate runs the same
  number of passes.
- ``band_distance_field`` with ``ijk_offset`` / ``upper_override`` on a
  block equals JAX's op by op (``jax.disable_jit``) bit for bit, and the
  global grid's band on the block's cells.
- Against JAX's ``sharded_sdf``: the end-to-end bars of
  tests/test_torch_modes.py (0 sign mismatches off the surface, the band
  within rtol 5e-5 / atol 2e-6, propagate every cell within 0.05 dx,
  eikonal rtol 1e-5 / atol 1e-6): JAX under jit contracts FMAs.
- The vertex gradient through ``sharded_sdf(verts=...)`` within 1e-4 of
  the largest component of the single-device port's (R1b's bar), the loss
  bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
from sdfgenfast_tpu.ops import band as jband
from sdfgenfast_tpu.parallel import sharded as jsh
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch.models import SDFGenerator
from sdfgenfast_tpu_torch.ops import band as pband
from sdfgenfast_tpu_torch.ops import sweep as psweep
from sdfgenfast_tpu_torch.parallel import sharded as psh

CPU = torch.device("cpu")
SURF_EPS = 1e-5

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)

ICO2 = dict(subdivisions=2, radius=1.0, center=(0.05, -0.02, 0.03))
ICO1 = dict(subdivisions=1, radius=1.0)
G32 = ((-1.4,) * 3, 0.0875, (32, 32, 32))
G1D = ((-1.3,) * 3, 2.6 / 32, (16, 16, 32))
BIN = dict(tile2d_shape=(8, 8), dense_max_tris=0)
BIN1D = dict(tile_shape=(8, 8, 4), tile2d_shape=(8, 4), dense_max_tris=0)

# name: (mesh, grid, SDFConfig knobs, mesh shape)
CASES = {
    "eikonal": (ICO2, G32, dict(BIN, far_field="eikonal"), (2, 4)),
    "eikonal-1x8": (ICO1, G1D, dict(BIN1D, far_field="eikonal",
                                    eikonal_iters=40), (1, 8)),
    "eikonal-device-sign": (ICO2, G32, dict(BIN, far_field="eikonal",
                                            sign_mode="device"), (2, 4)),
    "propagate": (ICO2, G32, dict(BIN, far_field="propagate", max_passes=8),
                  (2, 4)),
    "propagate-1x8": (ICO1, G1D, dict(BIN1D, far_field="propagate",
                                      max_passes=8), (1, 8)),
}


def _case(name):
    spec, (origin, dx, shape), knobs, dims = CASES[name]
    return (P.icosphere(**spec), P.GridSpec(origin, dx, shape),
            P.SDFConfig(**knobs), dims)


def pmesh(dims):
    return psh.make_device_mesh([CPU] * 8, dims)


def _passes(monkeypatch):
    """Record the pass counts of the single-device and the sharded plane
    scans."""
    seen = {}
    single, sharded = (psweep.propagate_closest_triangles,
                       psh._sharded_propagate)

    def spy_single(*a, **k):
        out = single(*a, **k)
        seen["single"] = out[2]
        return out

    def spy_sharded(*a, **k):
        out = sharded(*a, **k)
        seen["sharded"] = out[2]
        return out

    monkeypatch.setattr(psweep, "propagate_closest_triangles", spy_single)
    monkeypatch.setattr(psh, "_sharded_propagate", spy_sharded)
    return seen


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_single_device_bit_for_bit(name, monkeypatch):
    mesh, grid, cfg, dims = _case(name)
    seen = _passes(monkeypatch)
    want_phi, want_tid = P.make_level_set3(mesh, grid, cfg, device=CPU,
                                           return_tid=True)
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    phi, tid = psh.sharded_sdf(sb, pmesh(dims), verts=mesh.verts,
                               return_tid=True)
    assert phi.shape == grid.shape
    np.testing.assert_array_equal(phi.numpy().view(np.int32),
                                  want_phi.numpy().view(np.int32))
    np.testing.assert_array_equal(tid.numpy(), want_tid.numpy())
    if cfg.far_field == "propagate":
        assert seen["sharded"] == seen["single"] >= 2
        assert (tid >= 0).all()
    else:
        # the band's ids, -1 beyond it
        assert not seen and (tid >= 0).any()
    assert (tid < len(mesh.tris)).all()


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_meets_the_bars_against_jax(name):
    mesh, grid, cfg, dims = _case(name)
    jm = J.Mesh(mesh.verts, mesh.tris)
    jg = J.GridSpec(grid.origin, grid.dx, grid.shape)
    jc = J.SDFConfig(**dataclasses.asdict(cfg))
    jsb = jsh.bin_mesh_sharded(jm, jg, dims, jc)
    jphi = np.asarray(jsh.sharded_sdf(jsb, jsh.make_device_mesh(shape=dims),
                                      verts=mesh.verts))
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    phi = psh.sharded_sdf(sb, pmesh(dims), verts=mesh.verts).numpy()
    dx = grid.dx
    assert phi.shape == jphi.shape and np.isfinite(phi).all()
    off = np.minimum(np.abs(phi), np.abs(jphi)) > SURF_EPS
    assert (((phi < 0) != (jphi < 0)) & off).sum() == 0
    near = np.abs(jphi) < 2 * dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(jphi)[near],
                               rtol=5e-5, atol=2e-6)
    if cfg.far_field == "eikonal":
        np.testing.assert_allclose(phi, jphi, rtol=1e-5, atol=1e-6)
    else:
        err = np.abs(phi - jphi)
        assert err.max() <= 0.05 * dx, f"max err {err.max() / dx:.4f} dx"


@pytest.mark.parametrize("dims", [(2, 4), (1, 8)])
def test_band_distance_field_with_offset(dims):
    """Each block's band (``ijk_offset``, the global ``upper``) equals
    JAX's op by op and the global band's cells."""
    mesh, grid, cfg, _ = _case("eikonal" if dims == (2, 4) else
                               "eikonal-1x8")
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    dx = float(np.float32(grid.dx))
    origin = np.asarray(grid.origin, np.float32)
    tv = mesh.verts[mesh.tris].astype(np.float32)
    tile = tuple(int(v) for v in cfg.tile_shape)
    binned = P.bin_mesh(mesh, grid, cfg)
    gphi, gtid = pband.band_distance_field(
        torch.from_numpy(tv), *(torch.from_numpy(a) for a in (
            binned.active_ids, binned.cand, binned.cand_valid, origin)),
        dx, tile, binned.tiles_dim, grid.shape, chunk=cfg.band_chunk)
    ni, nj_l, nk_l = sb.block
    upper = np.float32(sum(grid.shape)) * np.float32(dx)
    for dj, dk in np.ndindex(*dims):
        off = (0, dj * nj_l, dk * nk_l)
        args = (sb.band_ids[dj, dk], sb.band_cand[dj, dk],
                sb.band_valid[dj, dk])
        phi, tid = pband.band_distance_field(
            torch.from_numpy(tv), *(torch.from_numpy(a) for a in args),
            torch.from_numpy(origin), dx, tile, sb.band_tiles_local,
            sb.block, chunk=cfg.band_chunk, ijk_offset=off,
            upper_override=upper)
        with jax.disable_jit():
            jphi, jtid = jband.band_distance_field(
                jnp.asarray(tv), *(jnp.asarray(a) for a in args),
                jnp.asarray(origin), jnp.float32(dx), tile_shape=tile,
                tiles_dim=sb.band_tiles_local, grid_shape=sb.block,
                chunk=cfg.band_chunk, ijk_offset=jnp.asarray(off, jnp.int32),
                upper_override=jnp.float32(upper))
        np.testing.assert_array_equal(phi.numpy().view(np.int32),
                                      np.asarray(jphi).view(np.int32))
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jtid))
        blk = (slice(None), slice(off[1], off[1] + nj_l),
               slice(off[2], off[2] + nk_l))
        np.testing.assert_array_equal(phi.numpy().view(np.int32),
                                      gphi.numpy()[blk].view(np.int32))
        np.testing.assert_array_equal(tid.numpy(), gtid.numpy()[blk])
    assert (gtid >= 0).any() and (gphi[gtid < 0] == float(upper)).all()


def test_eikonal_blocks_equal_the_whole_grid():
    """``eikonal_far_field(halo_extend=...)`` over the blocks of a (2, 4)
    mesh equals the iterations over the whole grid."""
    rng = np.random.default_rng(5)
    shape, dx = (6, 16, 24), 0.125
    phi = torch.from_numpy(rng.uniform(0, 4, shape).astype(np.float32))
    frozen = torch.from_numpy(rng.random(shape) < 0.1)
    phi = torch.where(frozen, phi * 0.1, torch.full_like(phi, 9.0))
    want = psweep.eikonal_far_field(phi, frozen, dx, 12)
    tr = psh.LocalTransport(pmesh((2, 4)).devices)

    def blocks(x):
        return tr.flat([[x[:, a * 8:(a + 1) * 8, b * 6:(b + 1) * 6]
                         for b in range(4)] for a in range(2)])

    got = psweep.eikonal_far_field(
        blocks(phi), blocks(frozen), dx, 12,
        halo_extend=lambda phis, axis: tr.flat(tr.extend(
            tr.unflat(phis), "jk"[axis - 1], axis, float("inf"))))
    whole = tr.gather(tr.unflat(got), 1, CPU)
    np.testing.assert_array_equal(whole.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    assert (want < 9.0).sum() > (phi < 9.0).sum()


def test_plane_scans_write_no_input():
    """The pass test compares a pass's end with its start: a scan that
    wrote its input (the i axis, whose planes need no transpose) made the
    start hold the pass's i sweeps, and the loop could stop a pass early."""
    rng = np.random.default_rng(6)
    shape = (6, 5, 7)
    phi = torch.from_numpy(rng.uniform(0, 4, shape).astype(np.float32))
    tid = torch.from_numpy(rng.integers(-1, 3, shape).astype(np.int32))
    tv = torch.from_numpy(rng.normal(size=(3, 3, 3)).astype(np.float32))
    before = (phi.clone(), tid.clone())
    out, _, _ = psweep.propagate_closest_triangles(phi, tid, tv,
                                                   torch.zeros(3), 0.5, 2)
    assert torch.equal(phi, before[0]) and torch.equal(tid, before[1])
    assert not torch.equal(out, phi)


@pytest.mark.parametrize("mode", ["eikonal", "propagate"])
def test_sharded_gradient_equals_single_device(mode):
    mesh, grid, cfg, dims = _case(mode)
    mesh = P.icosphere(2, radius=0.9, center=(0.02, 0.01, -0.03))
    single = SDFGenerator(mesh, grid, cfg, device=CPU)
    shard = SDFGenerator(mesh, grid, cfg, device_mesh=pmesh(dims))
    target = single.forward(single.params * 0.95).detach()

    def grad(model):
        v = model.params.requires_grad_(True)
        loss = model.loss(v, target)
        return loss.detach(), torch.autograd.grad(loss, v)[0]

    l1, g1 = grad(single)
    l8, g8 = grad(shard)
    assert float(l8) == float(l1)
    scale = float(g1.abs().max())
    assert scale > 0 and float((g8 - g1).abs().max()) <= 1e-4 * scale
    new, loss = shard.train_step(shard.params, target, lr=1e-2)
    assert float(loss) == float(l1) and torch.isfinite(new).all()
