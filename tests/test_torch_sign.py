"""The device sign of the PyTorch port (``sign_mode="device"``,
``sdfgenfast_tpu_torch/ops/sign.py``) on the CPU, and the two repairs that
came with it (the ``SDFConfig`` defaults, K2's normal scale).

Bars and why:

- ``bin_triangles_2d`` is host NumPy copied from the JAX package: its tiles
  and candidate matrices equal the JAX package's bit for bit, and the
  double-float split of the port's float64 coordinates equals JAX's
  ``f_hi`` / ``f_lo``.
- ``parity_field`` evaluates the host parity's float64 predicates in the
  host's operation order, so it equals ``ops/sign_host.parity_field_host``
  on every cell. The JAX package's device predicates run in double-float
  (~48 bits) and normalise the barycentric weights before summing, so
  they can decide a near-tie otherwise: the port equals JAX's
  ``parity_field`` wherever JAX's device and host parities agree, and
  JAX's host parity everywhere.
- End to end, the device sign changes only where the parity comes from:
  ``make_level_set3`` is bit-equal to the host sign on every route; against
  JAX's device mode it meets tests/test_torch_modes.py's bars (0 sign
  mismatches off the surface, the band at rtol 5e-5, every cell within
  0.05 dx, eikonal rtol 1e-5), against the goldens
  tests/test_parity_golden.py's.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sdfgenfast_tpu as J
from sdfgenfast_tpu.ops import sign as jsign
from sdfgenfast_tpu.ops import sign_host as jsign_host
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.models import SDFGenerator
from sdfgenfast_tpu_torch.ops import band_kernel
from sdfgenfast_tpu_torch.ops import sign as psign
from sdfgenfast_tpu_torch.ops import sign_host as psign_host
from test_torch_dense import assert_golden_bars, golden_grid

CPU = torch.device("cpu")
SURF_EPS = 1e-5

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _box_planes():
    # vertices on grid planes: the SOS tie-break gauntlet
    return (P.box_mesh((3, 4, 5), (-1, -1, -1)),
            P.GridSpec((-1.5, -1.5, -1.5), 0.25, (26, 28, 30)))


def _sphere2():
    return (P.icosphere(2, radius=1.0, center=(0.07, -0.04, 0.02)),
            P.GridSpec((-1.3, -1.3, -1.3), 0.1, (27, 28, 30)))


def _soup():
    rng = np.random.default_rng(11)
    verts = rng.uniform(-1.2, 1.2, size=(180, 3)).astype(np.float32)
    tris = np.arange(180, dtype=np.uint32).reshape(60, 3)
    return (P.Mesh(verts, tris),
            P.GridSpec((-1.5, -1.5, -1.5), 0.125, (24, 26, 22)))


def _outside():
    # beyond the grid on +j and -k: windows clamped to [nj-1, nj-1] and
    # [0, 0], and triangles whose clamped windows hold no crossing
    return (P.icosphere(2, radius=1.0, center=(0.1, 0.7, -0.5)),
            P.GridSpec((-1.2, -1.0, -1.0), 0.1, (25, 21, 19)))


MESHES = {"box_planes": _box_planes, "sphere2": _sphere2, "soup": _soup,
          "outside": _outside}


def _jax(mesh, grid):
    return (J.Mesh(mesh.verts, mesh.tris),
            J.GridSpec(grid.origin, grid.dx, grid.shape))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _parity(sb, grid, chunk=64, jk_offset=None):
    """The port's parity_field on the CPU from a SignBinning."""
    return psign.parity_field(
        _t(sb.f), _t(sb.window), _t(sb.active_ids), _t(sb.cand),
        _t(sb.cand_valid), sb.tile_shape, sb.tiles_dim, grid.shape,
        chunk=chunk, jk_offset=jk_offset).numpy()


def _host(mesh, grid):
    return psign_host.parity_field_host(mesh.verts, mesh.tris, grid)


# -- repairs: the SDFConfig defaults and K2's normal scale --------------------


def test_sdfconfig_defaults_equal_jax():
    """Every field of the port's SDFConfig has the JAX package's name and
    default (tile2d_shape was (8, 128) against JAX's (16, 16))."""
    jf = {f.name: f.default for f in dataclasses.fields(J.SDFConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(P.SDFConfig)}
    assert list(jf) == list(pf)
    assert {k: tuple(v) if isinstance(v, tuple) else v
            for k, v in jf.items()} == pf
    assert P.SDFConfig().tile2d_shape == psign.DEFAULT_TILE_2D == (16, 16)


@pytest.mark.parametrize("offset", [0.0, 1000.0], ids=["random", "far"])
def test_band_coefs_normal_is_correctly_rounded(offset):
    """K2's twin scales the normal by 1 / sqrt(max(|cr|^2, 1e-37)), the
    root and the division each rounded once: a float64 root rounded to
    float32, then an IEEE float32 division (NumPy), for random triangles
    and triangles 1000 units from the origin."""
    rng = np.random.default_rng(3)
    tri9 = (rng.normal(size=(2000, 9), scale=0.3).astype(np.float32)
            + np.float32(offset))
    a, b, c = tri9[:, 0:3], tri9[:, 3:6], tri9[:, 6:9]
    x13, x23 = a - c, b - c
    cr = np.stack([x13[:, 1] * x23[:, 2] - x13[:, 2] * x23[:, 1],
                   x13[:, 2] * x23[:, 0] - x13[:, 0] * x23[:, 2],
                   x13[:, 0] * x23[:, 1] - x13[:, 1] * x23[:, 0]], axis=1)
    cr2 = cr[:, 0] * cr[:, 0] + cr[:, 1] * cr[:, 1] + cr[:, 2] * cr[:, 2]
    root = np.sqrt(np.maximum(cr2, np.float32(1e-37)).astype(np.float64)
                   ).astype(np.float32)
    scale = np.float32(1.0) / root
    assert scale.dtype == np.float32
    want = cr * scale[:, None]
    got = band_kernel.band_coefs(_t(tri9)).numpy()[:, 0:3]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the host half: bin_triangles_2d ---------------------------------------


@pytest.mark.parametrize("tile", [(16, 16), (8, 8)], ids=lambda t: "x".join(
    map(str, t)))
@pytest.mark.parametrize("name", list(MESHES))
def test_bin_triangles_2d_equals_jax(name, tile):
    mesh, grid = MESHES[name]()
    jb = jsign.bin_triangles_2d(mesh.verts, mesh.tris, _jax(mesh, grid)[1],
                                tile)
    pb = psign.bin_triangles_2d(mesh.verts, mesh.tris, grid, tile)
    assert pb.tiles_dim == tuple(jb.tiles_dim) and pb.tile_shape == tile
    for key in ("active_ids", "cand", "cand_valid"):
        want, got = getattr(jb, key), getattr(pb, key)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert pb.f.dtype == np.float64
    hi, lo = jsign.split_f64_to_df(pb.f)
    np.testing.assert_array_equal(hi.view(np.int32), jb.f_hi.view(np.int32))
    np.testing.assert_array_equal(lo.view(np.int32), jb.f_lo.view(np.int32))
    # the window is the host parity's (sign_host.parity_field_host)
    fj, fk = pb.f[:, :, 1], pb.f[:, :, 2]
    nj, nk = grid.shape[1:]
    np.testing.assert_array_equal(pb.window, np.stack([
        np.clip(np.ceil(fj.min(1)), 0, nj - 1),
        np.clip(np.floor(fj.max(1)), 0, nj - 1),
        np.clip(np.ceil(fk.min(1)), 0, nk - 1),
        np.clip(np.floor(fk.max(1)), 0, nk - 1)], axis=1).astype(np.int32))


@pytest.mark.parametrize("name", list(MESHES))
def test_bin_mesh_device_sign_equals_jax(name):
    """bin_mesh in device mode: JAX's padded sign binning (sentinel T rows)
    bit for bit, no host parity; the dense path bins no band."""
    mesh, grid = MESHES[name]()
    for cfg in (dict(), dict(dense_max_tris=0)):
        jmesh, jgrid = _jax(mesh, grid)
        jb = J.bin_mesh(jmesh, jgrid, J.SDFConfig(sign_mode="device", **cfg))
        pb = ppipe.bin_mesh(mesh, grid, P.SDFConfig(sign_mode="device", **cfg))
        assert pb.parity_packed is None and pb.parity_crossings is None
        assert pb.sign.tiles_dim == tuple(jb.sign.tiles_dim)
        for key in ("active_ids", "cand", "cand_valid"):
            np.testing.assert_array_equal(getattr(pb.sign, key),
                                          getattr(jb.sign, key), err_msg=key)
        T = int(np.prod(pb.sign.tiles_dim))
        live = pb.sign.active_ids < T
        assert (pb.sign.active_ids[~live] == T).all()
        assert not pb.sign.cand_valid[~live].any()
        if ppipe.use_dense(pb.config, len(mesh.tris)):
            assert pb.tiles_dim is None and pb.band_csr is None


# -- the device half: parity_field -------------------------------------------


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("tile", [(16, 16), (8, 8), (8, 128)],
                         ids=lambda t: "x".join(map(str, t)))
def test_parity_field_equals_host_parity(tile, chunk):
    """Every cell equals the host parity, for every mesh (grids whose nj
    and nk are not multiples of the tile), from bin_mesh's padded binning
    (sentinel tile id T on the padded rows)."""
    for name, make in MESHES.items():
        mesh, grid = make()
        cfg = P.SDFConfig(sign_mode="device", tile2d_shape=tile)
        sb = ppipe.bin_mesh(mesh, grid, cfg).sign
        assert len(sb.active_ids) > np.count_nonzero(
            sb.active_ids < np.prod(sb.tiles_dim))  # sentinel rows present
        got = _parity(sb, grid, chunk=chunk)
        want = _host(mesh, grid)
        assert got.dtype == np.bool_ and got.shape == grid.shape
        assert want.any(), name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", ["empty", "left_of_grid"])
def test_parity_field_edge_binnings(case):
    """An empty binning (one triangle strictly between grid lines: no
    window, no tile) and a mesh wholly at j < 0 (every window clamped to
    [0, 0], no crossing inside it): both fields all False, as the host's."""
    if case == "empty":
        verts = np.array([[0.31, 0.32, 0.33], [0.36, 0.34, 0.35],
                          [0.33, 0.38, 0.37]], np.float32)
        mesh = P.Mesh(verts, np.array([[0, 1, 2]], np.uint32))
        grid = P.GridSpec((0.0, 0.0, 0.0), 0.1, (9, 10, 11))
    else:
        mesh = P.icosphere(1, radius=0.5, center=(0.0, -1.0, 0.0))
        grid = P.GridSpec((-1.0, 0.0, -1.0), 0.1, (20, 18, 21))
    sb = psign.bin_triangles_2d(mesh.verts, mesh.tris, grid)
    if case == "empty":
        assert sb.active_ids.shape == (0,)
    else:
        assert (sb.window[:, :2] == 0).all() and len(sb.active_ids) > 0
    got = _parity(sb, grid)
    np.testing.assert_array_equal(got, _host(mesh, grid))
    assert not got.any()


@pytest.mark.parametrize("name", list(MESHES))
def test_parity_field_against_jax(name):
    """The port's device parity equals JAX's host parity everywhere and
    JAX's device parity wherever JAX's device and host parities agree."""
    mesh, grid = MESHES[name]()
    jmesh, jgrid = _jax(mesh, grid)
    tile = (8, 8)
    jb = jsign.bin_triangles_2d(mesh.verts, mesh.tris, jgrid, tile)
    jdev = np.asarray(jsign.parity_field(
        jnp.asarray(jb.f_hi), jnp.asarray(jb.f_lo), jnp.asarray(jb.active_ids),
        jnp.asarray(jb.cand), jnp.asarray(jb.cand_valid), tile_shape=tile,
        tiles_dim=jb.tiles_dim, grid_shape=grid.shape, chunk=64))
    jhost = jsign_host.parity_field_host(mesh.verts, mesh.tris, jgrid)
    got = _parity(psign.bin_triangles_2d(mesh.verts, mesh.tris, grid, tile),
                  grid)
    np.testing.assert_array_equal(got, jhost)
    agree = jdev == jhost
    print(f"{name}: JAX's device parity differs from its host parity on "
          f"{int((~agree).sum())} of {agree.size} cells")
    np.testing.assert_array_equal(got[agree], jdev[agree])


@pytest.mark.parametrize("as_tensor", [False, True], ids=["ints", "tensor"])
def test_parity_field_jk_offset_block(as_tensor):
    """A block of tiles cut from the global binning and relabelled to
    local tile ids, with jk_offset the block's global (j, k), equals the
    global field's block."""
    mesh, grid = _sphere2()
    tile = (8, 8)
    sb = psign.bin_triangles_2d(mesh.verts, mesh.tris, grid, tile)
    full = _parity(sb, grid)
    ntk = sb.tiles_dim[1]
    tj0, tk0, btj, btk = 1, 1, 2, 2  # tiles j in [1, 3), k in [1, 3)
    tj, tk = sb.active_ids // ntk, sb.active_ids % ntk
    keep = (tj >= tj0) & (tj < tj0 + btj) & (tk >= tk0) & (tk < tk0 + btk)
    assert 0 < keep.sum() < len(keep)
    local = ((tj[keep] - tj0) * btk + (tk[keep] - tk0)).astype(np.int32)
    off = (tj0 * tile[0], tk0 * tile[1])
    block_grid = P.GridSpec(grid.origin, grid.dx,
                            (grid.shape[0], btj * tile[0], btk * tile[1]))
    block = dataclasses.replace(sb, tiles_dim=(btj, btk), active_ids=local,
                                cand=sb.cand[keep], cand_valid=sb.cand_valid[keep])
    got = _parity(block, block_grid, chunk=3,
                  jk_offset=torch.tensor(off) if as_tensor else off)
    want = full[:, off[0]:off[0] + btj * tile[0], off[1]:off[1] + btk * tile[1]]
    assert want.any()
    np.testing.assert_array_equal(got, want)


# -- end to end --------------------------------------------------------------


def _sphere3():
    return (P.icosphere(3, radius=1.0, center=(0.05, -0.03, 0.06)),
            P.GridSpec((-1.5, -1.5, -1.5), 0.15, (20, 20, 20)))


ROUTES = {
    "dense": (_box_planes, dict()),
    "exact": (_sphere3, dict()),
    "propagate": (_sphere3, dict(far_field="propagate")),
    "eikonal": (_sphere3, dict(far_field="eikonal")),
}


def _carry(jb, mesh, grid, cfg):
    """The port's Binned from the JAX device-mode Binned's arrays (its f
    from the port's own float64 coordinates)."""
    from sdfgenfast_tpu_torch.ops.band import triangle_grid_coords

    kw = dict(tris=jb.tris, seed_band=jb.seed_band, sign_ids=jb.sign.active_ids,
              sign_cand=jb.sign.cand, sign_valid=jb.sign.cand_valid,
              sign_f=triangle_grid_coords(mesh.verts, mesh.tris, grid),
              tile2d_shape=jb.sign.tile_shape, tiles2d_dim=jb.sign.tiles_dim)
    if not ppipe.use_dense(cfg, len(mesh.tris)):
        kw.update(tiles_dim=jb.band.tiles_dim, tile_shape=jb.band.tile_shape,
                  active_ids=jb.band.active_ids, cand=jb.band.cand,
                  cand_valid=jb.band.cand_valid)
        if jb.band_csr is not None:
            kw.update({k: jb.band_csr[k]
                       for k in ("pair", "off", "cnt", "ids", "kcap")})
    return ppipe.binned_from_arrays(grid, cfg, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_device_sign_end_to_end(route):
    """make_level_set3(sign_mode="device") is bit-equal to the host sign
    (from the port's own binning and from the JAX Binned carried across),
    and within the port-against-JAX bars of JAX's device mode."""
    make, knobs = ROUTES[route]
    mesh, grid = make()
    cfg = P.SDFConfig(sign_mode="device", **knobs)
    assert ppipe.use_dense(cfg, len(mesh.tris)) == (route == "dense")
    host = ppipe.make_level_set3(mesh, grid, P.SDFConfig(**knobs),
                                 device=CPU).numpy()
    own = ppipe.make_level_set3(mesh, grid, cfg, device=CPU).numpy()
    np.testing.assert_array_equal(own.view(np.int32), host.view(np.int32))

    jmesh, jgrid = _jax(mesh, grid)
    jcfg = J.SDFConfig(sign_mode="device", **knobs)
    jb = J.bin_mesh(jmesh, jgrid, jcfg)
    jphi = np.asarray(J.make_level_set3(jmesh, jgrid, jcfg, binned=jb))
    phi = ppipe.make_level_set3(mesh, grid, cfg, _carry(jb, mesh, grid, cfg),
                                device=CPU).numpy()
    np.testing.assert_array_equal(phi.view(np.int32), own.view(np.int32))
    off_surface = np.minimum(np.abs(phi), np.abs(jphi)) > SURF_EPS
    assert (((phi < 0) != (jphi < 0)) & off_surface).sum() == 0
    near = np.abs(jphi) < 2 * grid.dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(jphi)[near],
                               rtol=5e-5, atol=2e-6)
    if route == "eikonal":
        np.testing.assert_allclose(phi, jphi, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(phi - jphi).max() <= 0.05 * grid.dx


@pytest.mark.parametrize("name", ["box_stl_64_mode2a", "sphere_stl_64_mode2a"])
def test_device_sign_goldens(name):
    """The reference binary's 64-class goldens through generate_sdf in
    device sign mode (box: the dense path; icosphere(3): binned)."""
    mesh, grid, entry = golden_grid(name)
    phi = P.generate_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                         *grid.shape, backend="cpu",
                         config=P.SDFConfig(sign_mode="device"))
    assert_golden_bars(phi, grid, entry)


@pytest.mark.parametrize("route", ["dense", "exact"])
def test_sdf_generator_step_device_sign(route):
    """One SDFGenerator.train_step in device sign mode equals the host-mode
    step bit for bit (loss and new vertices)."""
    make, knobs = ROUTES[route]
    mesh, grid = make()
    out = []
    for sign_mode in ("host", "device"):
        model = SDFGenerator(mesh, grid, P.SDFConfig(sign_mode=sign_mode,
                                                     **knobs), device=CPU)
        assert (model.binned.sign is not None) == (sign_mode == "device")
        v0 = model.params
        with torch.no_grad():
            target = model.forward(v0 * 0.97)
        new, loss = model.train_step(v0, target, lr=1e-2)
        assert float(loss) > 0 and not torch.equal(new, v0)
        out.append((new.numpy(), loss.numpy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_generate_sdf_batch_device_sign():
    """generate_sdf_batch in device sign mode equals the host sign's batch,
    mesh by mesh, bit for bit (a dense box, a binned sphere)."""
    box = P.box_mesh((3, 4, 5), (-1.5, -2, -2.5))
    sphere = P.icosphere(3, radius=1.8)
    meshes = [(m.verts, m.tris) for m in (box, sphere)]
    args = ((-2.5, -3.0, -3.5), 0.25, 21, 25, 29)
    got = P.generate_sdf_batch(meshes, *args, backend="cpu",
                               config=P.SDFConfig(sign_mode="device"))
    want = P.generate_sdf_batch(meshes, *args, backend="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_binned_sign_mode_must_match_config():
    """No quiet fallback: a device-mode config with a host-mode Binned, or
    the reverse, raises."""
    mesh, grid = _box_planes()
    host_b = ppipe.bin_mesh(mesh, grid, P.SDFConfig())
    dev_b = ppipe.bin_mesh(mesh, grid, P.SDFConfig(sign_mode="device"))
    with pytest.raises(ValueError, match="sign binning"):
        ppipe.make_level_set3(mesh, grid, P.SDFConfig(sign_mode="device"),
                              host_b, device=CPU)
    with pytest.raises(ValueError, match="host parity"):
        ppipe.make_level_set3(mesh, grid, P.SDFConfig(), dev_b, device=CPU)
    with pytest.raises(ValueError, match="exactly one"):
        ppipe.binned_from_arrays(grid, P.SDFConfig(), tris=mesh.tris)
