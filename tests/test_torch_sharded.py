"""The port's sharded pipeline (``sdfgenfast_tpu_torch.parallel``) on the
CPU: eight shards on ``["cpu"] * 8`` as (2, 4) and (1, 8) meshes, beside
the JAX package on its eight virtual CPU devices (tests/conftest.py).

Bars and why:

- The host binning is the JAX package's, bit for bit (ids, candidates,
  global ids, the per-shard CSR, packed parity, the sign tiles), and
  ``halo_comms_model`` returns JAX's dict.
- The offset hooks of the kernels' twins: K2 with coordinate ids equals the
  global grid's rows at those tiles, K3 with a position offset (negative on
  the first blocks) equals the round over the whole grid inside the block,
  bit for bit; R1 with ``ijk_offset`` equals the global R1's block bit for
  bit and JAX's ``_recompute_phi(ijk_offset=...)`` at the R1 bar of
  tests/test_torch_grad.py (rtol 2e-6 / atol 1e-6 against jit; gradients
  2e-6 of the largest op by op).
- Every step of a shard equals the single-device step on its cells, so the
  sharded field and ids equal ``make_level_set3``'s bit for bit on grids
  whose k axis is the largest (the single-device pyramid's axis
  permutation is then the identity).
- Against JAX's ``sharded_sdf`` on the same mesh shape, the end-to-end
  bars the port's single-device path meets against JAX
  (tests/test_torch_pipeline.py, tests/test_torch_modes.py): 0 sign
  mismatches off the surface, the band (|phi| < 2 dx) within rtol 5e-5 /
  atol 2e-6, every cell within 0.05 dx. JAX under jit contracts FMAs and
  multi-round jump floods flip near-tie donors, so values differ by ulps:
  the pyramid-alone bar of tests/test_torch_vdt.py (>= 99.9% of cells
  within 1e-6 dx, on seeded fields at dx = 0.02) is not met end to end by
  the single-device path either (56-81% of cells on these cases, equal
  with and without sharding).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sdfgenfast_tpu as J
from sdfgenfast_tpu import pipeline as jpipe
from sdfgenfast_tpu.ops import sign as jsign
from sdfgenfast_tpu.parallel import sharded as jsh
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu_torch.models import SDFGenerator
from sdfgenfast_tpu_torch.ops import band_kernel, vdt as pvdt, vdt_kernel
from sdfgenfast_tpu_torch.ops import recompute as prc
from sdfgenfast_tpu_torch.parallel import multihost as pmh
from sdfgenfast_tpu_torch.parallel import sharded as psh

CPU = torch.device("cpu")
SURF_EPS = 1e-5
RTOL, ATOL = 2e-6, 1e-6  # R1 against jitted JAX (tests/test_torch_grad.py)

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _ico(level, **kw):
    return P.icosphere(level, **kw)


ICO2 = dict(level=2, radius=1.0, center=(0.05, -0.02, 0.03))
G32 = ((-1.4,) * 3, 0.0875, (32, 32, 32))
BIN = dict(tile2d_shape=(8, 8), dense_max_tris=0)

# name: (mesh, grid (origin, dx, shape), SDFConfig knobs, mesh shape)
CASES = {
    "pyramid-1-level": (ICO2, G32, BIN, (2, 4)),
    "pyramid-2-levels": (ICO2, ((-1.4,) * 3, 2.8 / 64, (64, 64, 64)), BIN,
                         (2, 4)),
    "pyramid-3-levels": (dict(level=3, radius=1.0, center=(0.03, -0.02, 0.01)),
                         ((-1.25,) * 3, 2.5 / 128, (8, 128, 128)), BIN,
                         (2, 4)),
    "capped": (ICO2, G32, dict(BIN, vdt_max_hop=4), (2, 4)),
    "dense": (ICO2, G32, dict(tile2d_shape=(8, 8)), (2, 4)),
    "tiles-4": ("box", ((-1.5,) * 3, 0.25, (28, 32, 32)),
                dict(BIN, tile_shape=(4, 4, 4)), (2, 4)),
    "tiles-884-1x8": (dict(level=1, radius=1.0), ((-1.3,) * 3, 0.1625,
                                                  (16, 16, 32)),
                      dict(tile_shape=(8, 8, 4), tile2d_shape=(8, 4),
                           dense_max_tris=0), (1, 8)),
    "device-sign": (ICO2, G32, dict(BIN, sign_mode="device"), (2, 4)),
    "device-sign-dense": (ICO2, G32, dict(tile2d_shape=(8, 8),
                                          sign_mode="device"), (2, 4)),
    "empty-shards": (dict(level=2, radius=0.35, center=(-0.8, -0.8, -0.8)),
                     G32, BIN, (2, 4)),
}
# the cases also run through JAX's sharded_sdf
JAX_CASES = ("pyramid-2-levels", "capped", "dense", "tiles-4", "device-sign")


def _mesh(spec):
    if spec == "box":
        return P.box_mesh((3, 4, 5), (-1, -1, -1))
    return _ico(**spec)


def _case(name):
    spec, (origin, dx, shape), knobs, dims = CASES[name]
    return (_mesh(spec), P.GridSpec(origin, dx, shape), P.SDFConfig(**knobs),
            dims)


def _jax(mesh, grid, cfg):
    return (J.Mesh(mesh.verts, mesh.tris), J.GridSpec(grid.origin, grid.dx,
                                                      grid.shape),
            J.SDFConfig(**dataclasses.asdict(cfg)))


def pmesh(dims):
    return psh.make_device_mesh([CPU] * 8, dims)


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    mesh, grid, cfg, dims = _case(request.param)
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    phi, tid = psh.sharded_sdf(sb, pmesh(dims), verts=mesh.verts,
                               return_tid=True)
    want_phi, want_tid = P.make_level_set3(mesh, grid, cfg, device=CPU,
                                           return_tid=True)
    return dict(name=request.param, mesh=mesh, grid=grid, cfg=cfg, dims=dims,
                sb=sb, phi=phi.numpy(), tid=tid.numpy(),
                want_phi=want_phi.numpy(), want_tid=want_tid.numpy())


def test_sharded_equals_single_device_bit_for_bit(run):
    assert run["phi"].shape == run["grid"].shape
    np.testing.assert_array_equal(run["phi"].view(np.int32),
                                  run["want_phi"].view(np.int32))
    np.testing.assert_array_equal(run["tid"], run["want_tid"])
    if run["name"] == "empty-shards":
        T = int(np.prod(run["sb"].band_tiles_local))
        empty = (run["sb"].band_ids >= T).all(axis=2)
        assert empty.any() and not empty.all()


@pytest.fixture(scope="module", params=JAX_CASES)
def jax_run(request):
    mesh, grid, cfg, dims = _case(request.param)
    jm, jg, jc = _jax(mesh, grid, cfg)
    jsb = jsh.bin_mesh_sharded(jm, jg, dims, jc)
    jphi = np.asarray(jsh.sharded_sdf(jsb, jsh.make_device_mesh(shape=dims),
                                      verts=mesh.verts))
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    phi = psh.sharded_sdf(sb, pmesh(dims), verts=mesh.verts).numpy()
    return dict(grid=grid, phi=phi, jphi=jphi)


def test_sharded_meets_the_bars_against_jax(jax_run):
    phi, jphi, dx = jax_run["phi"], jax_run["jphi"], jax_run["grid"].dx
    assert phi.shape == jphi.shape
    off = np.minimum(np.abs(phi), np.abs(jphi)) > SURF_EPS
    assert (((phi < 0) != (jphi < 0)) & off).sum() == 0
    near = np.abs(jphi) < 2 * dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(jphi)[near],
                               rtol=5e-5, atol=2e-6)
    err = np.abs(phi - jphi)
    assert err.max() <= 0.05 * dx, f"max err {err.max() / dx:.4f} dx"


BIN_CASES = ("pyramid-2-levels", "tiles-4", "dense", "device-sign",
             "tiles-884-1x8", "empty-shards")


@pytest.mark.parametrize("name", BIN_CASES)
def test_binning_equals_jax(name):
    mesh, grid, cfg, dims = _case(name)
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    jm, jg, jc = _jax(mesh, grid, cfg)
    jsb = jsh.bin_mesh_sharded(jm, jg, dims, jc)

    def norm(v):
        return (v if v is None or isinstance(v, int)
                else tuple(int(x) for x in v))

    for f in ("dims", "block", "band_tiles_local", "band_tiles_global",
              "kcap", "sign_tiles_local"):
        assert norm(getattr(sb, f)) == norm(getattr(jsb, f)), f
    for f in ("band_ids", "band_cand", "band_valid", "band_gids",
              "parity_packed", "tris", "csr_pair", "csr_off", "csr_cnt",
              "sign_ids", "sign_cand", "sign_valid"):
        ours, theirs = getattr(sb, f), getattr(jsb, f)
        assert (ours is None) == (theirs is None), f
        if ours is not None:
            assert ours.dtype == theirs.dtype, f
            np.testing.assert_array_equal(ours, theirs, err_msg=f)
    if cfg.sign_mode == "device":
        hi, lo = jsign.split_f64_to_df(sb.f)
        np.testing.assert_array_equal(hi.view(np.int32),
                                      jsb.f_hi.view(np.int32))
        np.testing.assert_array_equal(lo.view(np.int32),
                                      jsb.f_lo.view(np.int32))
    else:
        assert sb.f is None and jsb.f_hi is None


@pytest.mark.parametrize("args", [
    ((8, 128, 128), (2, 4)), ((256, 256, 256), (2, 2)),
    ((64, 64, 64), (2, 4), 4), ((512, 512, 512), (1, 4), 8, 2)])
def test_halo_comms_model_equals_jax(args):
    assert psh.halo_comms_model(*args) == jsh.halo_comms_model(*args)


def test_make_device_mesh():
    dm = psh.make_device_mesh(["cpu"] * 8)
    assert dm.devices.shape == (2, 4)
    assert all(d == CPU for d in dm.devices.flat)
    assert psh.make_device_mesh([CPU] * 6).devices.shape == (2, 3)
    assert psh.make_device_mesh([CPU] * 8, (1, 8)).devices.shape == (1, 8)
    with pytest.raises(ValueError):
        psh.make_device_mesh([CPU] * 8, (3, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            psh.make_device_mesh()


# -- the kernels' twins at the shards' offsets -------------------------------


def test_k2_twin_with_coordinate_ids_equals_global_rows():
    mesh, grid, cfg, dims = _case("pyramid-2-levels")
    sb = psh.bin_mesh_sharded(mesh, grid, dims, cfg)
    binned = P.bin_mesh(mesh, grid, cfg)
    dx = float(np.float32(grid.dx))
    tri9 = torch.from_numpy(
        (mesh.verts[binned.tris] - np.asarray(grid.origin, np.float32))
        .reshape(-1, 9).astype(np.float32))
    g = binned.band_csr
    glob = band_kernel.band_rows_reference(
        tri9, *(torch.from_numpy(g[k]) for k in ("pair", "ids", "off",
                                                 "cnt")), dx,
        tiles_dim=binned.tiles_dim, grid_shape=grid.shape)
    T = int(np.prod(sb.band_tiles_local))
    for dj, dk in np.ndindex(*dims):
        ids = sb.band_ids[dj, dk]
        rows = band_kernel.band_rows(
            tri9, *(torch.from_numpy(a[dj, dk]) for a in (
                sb.csr_pair, sb.band_ids, sb.csr_off, sb.csr_cnt)), dx,
            tiles_dim=sb.band_tiles_local, grid_shape=sb.block,
            coord_ids=torch.from_numpy(sb.band_gids[dj, dk]),
            coord_tiles_dim=sb.band_tiles_global,
            coord_grid_shape=grid.shape)
        live = ids < T
        for r, w in zip(rows, glob):
            np.testing.assert_array_equal(
                r.numpy()[ids[live]].view(np.int32),
                w.numpy()[sb.band_gids[dj, dk][live]].view(np.int32))
            # a tile of no row keeps the no-candidate values
            rest = np.setdiff1d(np.arange(T), ids[live])
            np.testing.assert_array_equal(r.numpy()[rest],
                                          r.numpy()[T:T + 1].repeat(
                                              len(rest), 0))


def _seeded_state(shape, dx, seed, n_seed=3000):
    """(5, ni, nj, nk) float32: FAR but for `n_seed` seeded cells."""
    rng = np.random.default_rng(seed)
    st = np.full((5,) + shape, pvdt.FAR, np.float32)
    ii, jj, kk = (rng.integers(0, n, n_seed) for n in shape)
    cp = (rng.normal(size=(3, n_seed)).astype(np.float32) * 0.3
          + np.stack([ii, jj, kk]).astype(np.float32) * dx)
    st[0, ii, jj, kk], st[1, ii, jj, kk], st[2, ii, jj, kk] = cp
    st[3, ii, jj, kk] = rng.integers(0, 1 << 24, n_seed).astype(
        np.int32).view(np.float32)
    t = torch.from_numpy(st)
    pos = pvdt._level_pos_axes(shape, float(dx), 1, CPU)
    t[4] = pvdt._dist2(*pos, t[0], t[1], t[2])
    return t


@pytest.mark.parametrize("dims", [(2, 4), (1, 8)])
@pytest.mark.parametrize("scale", [1, 2])
def test_k3_twin_with_position_offset_equals_global_round(dims, scale):
    dx = float(np.float32(0.02))
    st = _seeded_state((10, 32, 64), np.float32(dx), 3 + scale)
    bj, bk = 32 // dims[0], 64 // dims[1]
    blocks = [[st[:, :, a * bj:(a + 1) * bj, b * bk:(b + 1) * bk].contiguous()
               for b in range(dims[1])] for a in range(dims[0])]
    for s in (1, 2, 3, 8):
        full = vdt_kernel.round_phase(st, dx, (s,), scale)
        ext = psh._state_halo_extend(psh.LocalTransport(pmesh(dims).devices),
                                     blocks, s)
        for a, b in np.ndindex(*dims):
            off = (0, a * bj - s, b * bk - s)  # negative on the first blocks
            got = vdt_kernel.round_phase(ext[a][b], dx, (s,), scale,
                                         pos_offset=off)
            np.testing.assert_array_equal(
                got[:, :, s:-s, s:-s].numpy().view(np.int32),
                full[:, :, a * bj:(a + 1) * bj,
                     b * bk:(b + 1) * bk].numpy().view(np.int32))


def test_vdt_far_field_blocks_equal_the_capped_ladder():
    """The capped ladder over blocks (``halo_extend``) equals the ladder of
    Jacobi rounds over the whole grid."""
    mesh, grid, cfg, dims = _case("capped")
    dx = float(np.float32(grid.dx))
    st = _seeded_state(grid.shape, np.float32(dx), 9)
    tid = st[3].view(torch.int32)
    phi_seed = torch.full(grid.shape, 7.0)
    freeze = tid >= 0
    strides = (4, 4, 2, 1, 1)
    kw = dict(jacobi=True, phase=vdt_kernel.round_phase)
    want = pvdt.vdt_far_field(st[0], st[1], st[2], tid, phi_seed, dx, strides,
                              freeze_mask=freeze, **kw)
    Dj, Dk = dims
    bj, bk = grid.shape[1] // Dj, grid.shape[2] // Dk

    def cut(x):
        return [x[:, a * bj:(a + 1) * bj, b * bk:(b + 1) * bk].contiguous()
                for a in range(Dj) for b in range(Dk)]

    tr = psh.LocalTransport(pmesh(dims).devices)
    got = pvdt.vdt_far_field(
        *(cut(x) for x in (st[0], st[1], st[2], tid, phi_seed)), dx, strides,
        freeze_mask=cut(freeze), ijk_offset=[
            (0, a * bj, b * bk) for a in range(Dj) for b in range(Dk)],
        halo_extend=lambda states, s: tr.flat(psh._state_halo_extend(
            tr, tr.unflat(states), s)), **kw)
    for i, w in enumerate(want):
        blocks = tr.unflat([g[i] for g in got])
        whole = torch.cat([torch.cat(r, dim=2) for r in blocks], dim=1)
        np.testing.assert_array_equal(whole.numpy().view(np.int32),
                                      w.numpy().view(np.int32))


def test_r1_twin_with_ijk_offset():
    rng = np.random.default_rng(11)
    m, shape, off = 40, (12, 10, 14), (3, 16, 40)
    tv = rng.normal(size=(m, 3, 3)).astype(np.float32) * 0.6 + 2.0
    tid = rng.integers(-1, m, shape).astype(np.int32)
    parity = rng.random(shape) < 0.5
    w = rng.normal(size=shape).astype(np.float32)
    origin = np.asarray([-0.7, -0.6, -0.8], np.float32)
    dx = np.float32(0.11)
    upper = float(np.float32(90) * dx)
    t = torch.from_numpy(tv).requires_grad_()
    phi = prc.recompute_phi(t, torch.from_numpy(tid), torch.from_numpy(parity),
                            origin, float(dx), upper, ijk_offset=off)
    (phi * torch.from_numpy(w)).sum().backward()

    # bit-equal to the same cells of a grid that holds the block at `off`
    big = tuple(o + n for o, n in zip(off, shape))
    tid_big = np.full(big, -1, np.int32)
    par_big = np.zeros(big, bool)
    sl = tuple(slice(o, o + n) for o, n in zip(off, shape))
    tid_big[sl], par_big[sl] = tid, parity
    whole = prc.recompute_forward_reference(
        torch.from_numpy(tv), torch.from_numpy(tid_big),
        torch.from_numpy(par_big), origin, float(dx), upper)
    np.testing.assert_array_equal(phi.detach().numpy().view(np.int32),
                                  whole.numpy()[sl].view(np.int32))

    def f(v):
        phi = jpipe._recompute_phi(v, jnp.asarray(tid), jnp.asarray(parity),
                                   jnp.asarray(origin), jnp.float32(dx),
                                   jnp.float32(upper),
                                   ijk_offset=jnp.asarray(off, jnp.int32))
        return jnp.sum(phi * w), phi

    (_, jphi), _ = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tv))
    np.testing.assert_allclose(phi.detach().numpy(), np.asarray(jphi),
                               rtol=RTOL, atol=ATOL)
    with jax.disable_jit():
        _, jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tv))
    jg = np.asarray(jg)
    assert np.abs(t.grad.numpy() - jg).max() <= 2e-6 * np.abs(jg).max()


def test_recompute_phi_runs_on_the_twins_in_place_of_the_wrappers(
        monkeypatch):
    """chip_smoke.time_differentiable swaps R1/R1b's wrappers for their
    twins inside recompute_phi: the twins take every argument the
    autograd Function passes, the offset included."""
    rng = np.random.default_rng(4)
    tv = torch.from_numpy(rng.normal(size=(6, 3, 3)).astype(np.float32))
    tid = torch.from_numpy(rng.integers(-1, 6, (4, 5, 6)).astype(np.int32))
    parity = torch.from_numpy(rng.random((4, 5, 6)) < 0.5)
    args = (tid, parity, (0.1, 0.2, 0.3), 0.25, 9.0)
    t = tv.clone().requires_grad_()
    prc.recompute_phi(t, *args, ijk_offset=(1, 2, 3)).sum().backward()
    monkeypatch.setattr(prc, "recompute_forward",
                        prc.recompute_forward_reference)
    monkeypatch.setattr(prc, "recompute_backward",
                        prc.recompute_backward_reference)
    t2 = tv.clone().requires_grad_()
    prc.recompute_phi(t2, *args, ijk_offset=(1, 2, 3)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), t2.grad.numpy())


# -- errors ------------------------------------------------------------------


def test_errors(tmp_path):
    box = P.box_mesh()
    with pytest.raises(ValueError, match="divide"):
        psh.bin_mesh_sharded(box, P.GridSpec((-0.5,) * 3, 0.2, (10, 11, 13)),
                             (2, 4))
    m = _ico(**ICO2)
    cfg = P.SDFConfig(**BIN)
    small = P.GridSpec((-1.25,) * 3, 2.5 / 128, (8, 128, 64))  # nk_l 8 < 16
    sb = psh.bin_mesh_sharded(m, small, (1, 8), cfg)
    with pytest.raises(ValueError, match="pyramid"):
        psh.sharded_sdf(sb, pmesh((1, 8)), verts=m.verts)
    g = P.GridSpec(*G32)
    # the multi-process path rejects propagate, as the JAX package does
    sb = psh.bin_mesh_sharded(m, g, (2, 4),
                              dataclasses.replace(cfg, far_field="propagate"))
    with pytest.raises(NotImplementedError, match="'exact' and 'eikonal'"):
        pmh.sharded_sdf_multihost(sb, pmesh((2, 4)), m.verts)
    # a mesh whose shards live in two processes: no gradient path
    two = dataclasses.replace(pmesh((2, 4)),
                              ranks=np.repeat([[0], [1]], 4, axis=1))
    with pytest.raises(ValueError, match="process"):
        SDFGenerator(m, g, device_mesh=two)
    with pytest.raises(ValueError, match="multihost"):
        psh.sharded_sdf(sb, two, verts=m.verts)
    pmh.initialize(f"file://{tmp_path / 'pg'}", 1, 0, "gloo")
    try:
        with pytest.raises(ValueError, match="does not hold"):
            pmh.global_device_mesh(["cpu"] * 3, (2, 2))
        assert pmh.global_device_mesh(["cpu"] * 2).ranks.tolist() == [[0, 0]]
    finally:
        torch.distributed.destroy_process_group()
    sb = psh.bin_mesh_sharded(m, g, (2, 4),
                              dataclasses.replace(cfg, vdt_max_hop=16))
    with pytest.raises(ValueError, match="vdt_max_hop"):
        psh.sharded_sdf(sb, pmesh((2, 4)), verts=m.verts)
    sb = psh.bin_mesh_sharded(m, g, (2, 4), cfg)
    with pytest.raises(ValueError, match="verts"):
        psh.sharded_sdf(sb, pmesh((2, 4)))
    with pytest.raises(ValueError):
        psh.sharded_sdf(sb, pmesh((1, 8)), verts=m.verts)
    with pytest.raises(TypeError, match="device_mesh"):
        psh.sharded_sdf(sb, object(), verts=m.verts)


# -- the entry points --------------------------------------------------------


def test_generate_sdf_batch_with_device_mesh_equals_single_device():
    origin, dx, shape = G32
    meshes = [(m.verts, m.tris) for m in (
        _ico(**ICO2), _ico(3, radius=0.9, center=(0.02, 0.01, -0.03)),
        P.box_mesh((2, 1.5, 1), (-1, -0.8, -0.5)))]
    args = (meshes, origin, dx, *shape)
    want = P.generate_sdf_batch(*args, backend="cpu")
    got = P.generate_sdf_batch(*args, backend="cpu", device_mesh=pmesh((2, 4)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    with pytest.raises(ValueError, match="not both"):
        P.generate_sdf_batch(*args, backend="cpu", device="cpu",
                             device_mesh=pmesh((2, 4)))
    meta = np.empty((1, 1), dtype=object)
    meta[0, 0] = torch.device("meta")
    with pytest.raises(ValueError, match="cpu devices"):
        P.generate_sdf_batch(*args, backend="cpu",
                             device_mesh=psh.DeviceMesh(meta))


def test_sdf_generator_with_device_mesh_train_step():
    m = _ico(3, radius=0.9, center=(0.02, 0.01, -0.03))
    g = P.GridSpec(*G32)
    single = SDFGenerator(m, g, device=CPU)
    shard = SDFGenerator(m, g, device_mesh=pmesh((2, 4)))
    assert shard.device == CPU and shard.sharded_binned is not None
    target = single.forward(single.params * 0.95).detach()
    lr = 1e-2
    new1, loss1 = single.train_step(single.params, target, lr=lr)
    new8, loss8 = shard.train_step(shard.params, target, lr=lr)
    assert loss8.dtype == loss1.dtype and float(loss8) == float(loss1)
    step = (single.params - new1).abs().max()
    assert step > 0
    assert float((new8 - new1).abs().max()) <= 1e-4 * float(step)
