"""The port's differentiable path (recompute twin R1/R1b, ``make_level_set3(
..., verts=...)``, ``models.SDFGenerator``) against the JAX package on the CPU.

Bars and why:

- phi: rtol 2e-6 / atol 1e-6, the dense path's bar (XLA's CPU compiler
  contracts products and sums into FMAs under jit; the port rounds every
  operation on its own, as the CUDA kernels built ``--fmad=false`` do).
- Vertex gradients, against ``jax.grad`` under jit: 1e-4 of the largest
  gradient. The gradient carries terms through the barycentric weights and
  edge parameters that vanish in exact arithmetic but not in float32, and
  they scale the FMA-contraction differences by up to |p - c| / |edge|;
  measured 1.5e-5 to 3e-5 of the largest gradient on these meshes.
- Against JAX's recompute stage run op by op (``jax.disable_jit()``: no
  contraction), on the same ids and parity: 2e-6 of the largest gradient
  (measured ~3e-7: the sqrt's gradient is taken in float64 by the port's
  CPU twin, and the sums run in another order).
- End to end the two packages pick the lowest-id closest triangle at exact
  float32 ties differently where their arithmetic differs (and the binned
  far fields differ at near-ties, tests/test_torch_pipeline.py), so the
  share of equal ids is asserted, and the gradients are compared both on the
  JAX package's ids and end to end.

At an exact float32 tie of two candidate edges, ``jax.grad`` under jit
can give 1.5 times the gradient that the same function gives op by op
(seen on icosphere(3) at 29^3, binned). It does not occur on these grids;
ROADMAP queue 3 records it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu import pipeline as jpipe
from sdfgenfast_tpu.mesh import icosphere as j_icosphere
from sdfgenfast_tpu.models import SDFGenerator as JGenerator
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.models import SDFGenerator, sgd_step
from sdfgenfast_tpu_torch.ops import recompute as prc

CPU = torch.device("cpu")
RTOL, ATOL = 2e-6, 1e-6
GRAD_JIT = 1e-4  # of max |g|, against jax.grad under jit
GRAD_EAGER = 2e-6  # of max |g|, against JAX op by op

torch.set_num_threads(1)


def _grad_close(got, want, frac, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: max err {err:.3e} > {frac} * {scale:.3e}"


# -- the recompute stage on seeded inputs -------------------------------------


def _random_stage(seed=0, shape=(12, 10, 14), m=40):
    rng = np.random.default_rng(seed)
    tv = rng.normal(size=(m, 3, 3)).astype(np.float32) * 0.6
    tid = rng.integers(-1, m, shape).astype(np.int32)
    parity = rng.random(shape) < 0.5
    w = rng.normal(size=shape).astype(np.float32)
    origin = np.asarray([-0.7, -0.6, -0.8], np.float32)
    return tv, tid, parity, w, origin, np.float32(0.11)


def _jax_stage(tv, tid, parity, w, origin, dx, eager=False):
    def f(t):
        phi = jpipe._recompute_stage(t, jnp.asarray(tid), jnp.asarray(parity),
                                     jnp.asarray(origin), jnp.float32(dx))
        return jnp.sum(phi * w), phi

    if eager:
        with jax.disable_jit():
            (_, phi), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tv))
    else:
        (_, phi), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(tv))
    return np.asarray(phi), np.asarray(g)


def _port_stage(tv, tid, parity, w, origin, dx):
    t = torch.from_numpy(tv.copy()).requires_grad_()
    phi = prc.recompute_stage(t, torch.from_numpy(tid),
                              torch.from_numpy(parity), origin, dx)
    (phi * torch.from_numpy(w)).sum().backward()
    return phi.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_recompute_twin_matches_jax_recompute_stage(seed):
    tv, tid, parity, w, origin, dx = _random_stage(seed)
    jphi, jg = _jax_stage(tv, tid, parity, w, origin, dx)
    phi, g = _port_stage(tv, tid, parity, w, origin, dx)
    np.testing.assert_allclose(phi, jphi, rtol=RTOL, atol=ATOL)
    assert np.array_equal(phi < 0, parity)
    upper = np.float32(sum(tid.shape)) * dx
    assert (np.abs(phi[tid < 0]) == upper).all()
    assert np.isfinite(g).all()
    _grad_close(g, jg, GRAD_JIT, "vs jax.grad under jit")
    _, eg = _jax_stage(tv, tid, parity, w, origin, dx, eager=True)
    _grad_close(g, eg, GRAD_EAGER, "vs JAX op by op")


def test_recompute_twin_degenerate_triangles():
    """Zero-area triangles get a finite gradient: a point triangle's goes
    wholly to its last vertex, d(phi)/dc = sign * (c - p) / |c - p|. (The
    JAX package's is NaN there: its maximum and division gradients multiply
    a zero mask by an overflowed 1/den^2.)"""
    tv, tid, parity, w, origin, dx = _random_stage(6)
    tv[0] = tv[0, 0]  # a point
    tv[1, 2] = tv[1, 1]  # a segment
    tid[:, :, :3] = 0
    tid[:, :, 3:6] = 1
    phi, g = _port_stage(tv, tid, parity, w, origin, dx)
    assert np.isfinite(g).all()
    assert (g[0, :2] == 0).all()
    cells = np.argwhere(tid == 0)
    p = cells.astype(np.float32) * dx + origin
    diff = (tv[0, 2] - p).astype(np.float64)
    d = np.linalg.norm(diff, axis=1)
    sign = np.where(parity[tid == 0], -1.0, 1.0)
    want = ((w[tid == 0] * sign / d)[:, None] * diff).sum(0)
    np.testing.assert_allclose(g[0, 2], want, rtol=1e-5)


def test_recompute_twin_chunking_is_invisible():
    """The 2^20-cell chunks of forward and backward: any chunk size gives
    the same phi bit for bit and the same gradient (per-cell values are
    independent of the chunk; the float64 sums differ in order only)."""
    tv, tid, parity, w, origin, dx = _random_stage(2)
    args = (torch.from_numpy(tv), torch.from_numpy(tid),
            torch.from_numpy(parity))
    o = tuple(float(v) for v in origin)
    upper = float(np.float32(sum(tid.shape)) * dx)
    full = prc.recompute_forward_reference(*args, o, float(dx), upper)
    small = prc.recompute_forward_reference(*args, o, float(dx), upper,
                                            chunk_cells=333)
    assert torch.equal(full.view(torch.int32), small.view(torch.int32))
    gp = torch.from_numpy(w)
    g_full = prc.recompute_backward_reference(*args, gp, o, float(dx), upper)
    g_small = prc.recompute_backward_reference(*args, gp, o, float(dx), upper,
                                               chunk_cells=333)
    np.testing.assert_allclose(g_small.numpy(), g_full.numpy(), rtol=1e-6,
                               atol=1e-6 * float(g_full.abs().max()))


def test_recompute_phi_saves_only_the_frozen_fields():
    tv, tid, parity, w, origin, dx = _random_stage(3)
    t = torch.from_numpy(tv).requires_grad_()
    phi = prc.recompute_stage(t, torch.from_numpy(tid),
                              torch.from_numpy(parity), origin, dx)
    saved = phi.grad_fn.saved_tensors
    assert len(saved) == 3
    assert [tuple(s.shape) for s in saved] == [tv.shape, tid.shape,
                                               parity.shape]


def test_recompute_wrappers_validate_their_input():
    tv, tid, parity, w, origin, dx = _random_stage(4)
    t, i, p = (torch.from_numpy(v) for v in (tv, tid, parity))
    with pytest.raises(ValueError, match="int32"):
        prc.recompute_forward(t, i.long(), p, origin, dx, 1.0)
    with pytest.raises(ValueError, match="bool"):
        prc.recompute_forward(t, i, p.to(torch.uint8), origin, dx, 1.0)
    with pytest.raises(ValueError, match="float32"):
        prc.recompute_backward(t, i, p, torch.from_numpy(w).double(),
                               origin, dx, 1.0)


def test_clip_ties_split_the_gradient_as_jax_does():
    """An edge parameter exactly on its clamp bound passes half of its
    gradient (jnp.clip); torch.clamp would pass all of it."""
    from sdfgenfast_tpu.ops import geometry as jgeom
    from sdfgenfast_tpu_torch.ops import geometry as pgeom

    for s in (0.0, 1.0):
        jg = float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(jnp.float32(s)))
        pt = torch.tensor(s, requires_grad=True)
        pgeom._clip01(pt).backward()
        assert float(pt.grad) == jg == 0.5
    # through the distance: point p projects exactly onto vertex b of edge
    # ab (s == 0) with a tie between edges ab and bc
    p = np.asarray([2.0, 0.0, 0.0], np.float32)
    tri = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)

    def jf(t):
        return jgeom.point_triangle_distance_sq_soa(
            tuple(jnp.asarray(p[i]) for i in range(3)), tuple(t[0]),
            tuple(t[1]), tuple(t[2]))

    want = np.asarray(jax.grad(jf)(jnp.asarray(tri)))
    t = torch.from_numpy(tri.copy()).requires_grad_()
    pgeom.point_triangle_distance_sq_soa(
        tuple(torch.tensor(p[i]) for i in range(3)), tuple(t[0]), tuple(t[1]),
        tuple(t[2])).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-7)


def test_gather_tri9_matches_jax():
    from sdfgenfast_tpu.ops import geometry as jgeom
    from sdfgenfast_tpu_torch.ops import geometry as pgeom

    rng = np.random.default_rng(5)
    tri9 = rng.normal(size=(9, 30)).astype(np.float32)
    tid = rng.integers(-2, 30, (4, 5, 6)).astype(np.int32)
    want = jgeom.gather_tri9(jnp.asarray(tri9), jnp.asarray(tid))
    got = pgeom.gather_tri9(torch.from_numpy(tri9), torch.from_numpy(tid))
    for wv, gv in zip(want, got):
        for a, b in zip(wv, gv):
            assert b.shape == tid.shape
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# -- make_level_set3(verts=...) against jax.grad ------------------------------

PATHS = {"dense": 1024, "binned": 0}


def _ico1_problem(dense_max_tris):
    m = j_icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
    g = J.GridSpec((-1.3, -1.3, -1.3), 2.6 / 16, (16, 16, 16))
    return m, g, J.SDFConfig(dense_max_tris=dense_max_tris)


@pytest.fixture(scope="module", params=sorted(PATHS))
def grad_run(request):
    m, g, cfg = _ico1_problem(PATHS[request.param])
    jb = J.bin_mesh(m, g, cfg)
    w = np.random.default_rng(1).standard_normal(g.shape).astype(np.float32)

    def f(v):
        phi, tid = J.make_level_set3(m, g, cfg, binned=jb, verts=v,
                                     return_tid=True)
        return jnp.sum(phi * w), (phi, tid)

    (_, (jphi, jtid)), jg = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(m.verts))
    pm = P.Mesh(m.verts, m.tris)
    pg = P.GridSpec(g.origin, g.dx, g.shape)
    pcfg = P.SDFConfig(dense_max_tris=PATHS[request.param])
    v = torch.from_numpy(m.verts.copy()).requires_grad_()
    phi, tid = P.make_level_set3(pm, pg, pcfg, device=CPU, verts=v,
                                 return_tid=True)
    (phi * torch.from_numpy(w)).sum().backward()
    return dict(path=request.param, m=m, g=g, cfg=pcfg, w=w,
                jphi=np.array(jphi), jtid=np.array(jtid),
                jg=np.asarray(jg), phi=phi.detach().numpy(),
                tid=tid.numpy(), g_port=v.grad.numpy())


def test_make_level_set3_path(grad_run):
    r = grad_run
    binned = P.bin_mesh(P.Mesh(r["m"].verts, r["m"].tris),
                        P.GridSpec(r["g"].origin, r["g"].dx, r["g"].shape),
                        r["cfg"])
    assert (binned.band_csr is None) == (r["path"] == "dense")


def test_make_level_set3_gradient_matches_jax_end_to_end(grad_run):
    r = grad_run
    assert (r["tid"] == r["jtid"]).mean() >= 0.9
    np.testing.assert_allclose(r["phi"], r["jphi"], rtol=RTOL, atol=ATOL)
    assert np.isfinite(r["g_port"]).all()
    _grad_close(r["g_port"], r["jg"], GRAD_JIT, "end to end")


def test_make_level_set3_gradient_matches_jax_on_equal_ids(grad_run):
    """The port's recompute on the JAX package's own ids and parity."""
    r = grad_run
    m, g = r["m"], r["g"]
    parity = r["jphi"] < 0  # |phi| >= 1e-15 everywhere: the sign is parity
    v = torch.from_numpy(m.verts.copy()).requires_grad_()
    phi = prc.recompute_stage(v[torch.from_numpy(m.tris.astype(np.int64))],
                              torch.from_numpy(r["jtid"]),
                              torch.from_numpy(parity), g.origin, g.dx)
    (phi * torch.from_numpy(r["w"])).sum().backward()
    np.testing.assert_allclose(phi.detach().numpy(), r["jphi"], rtol=RTOL,
                               atol=ATOL)
    _grad_close(v.grad.numpy(), r["jg"], GRAD_JIT, "on JAX's ids")

    tr = jnp.asarray(m.tris.astype(np.int32))

    def f(vv):
        return jnp.sum(jpipe._recompute_phi(
            vv[tr], jnp.asarray(r["jtid"]), jnp.asarray(parity),
            jnp.asarray(g.origin, jnp.float32), jnp.float32(g.dx),
            jnp.float32(sum(g.shape)) * jnp.float32(g.dx)) * r["w"])

    with jax.disable_jit():
        eg = np.asarray(jax.grad(f)(jnp.asarray(m.verts)))
    _grad_close(v.grad.numpy(), eg, GRAD_EAGER, "on JAX's ids, op by op")


def test_verts_override_is_checked():
    m, g, _ = _ico1_problem(1024)
    pm = P.Mesh(m.verts, m.tris)
    pg = P.GridSpec(g.origin, g.dx, g.shape)
    with pytest.raises(ValueError, match="shape"):
        P.make_level_set3(pm, pg, device=CPU,
                          verts=torch.zeros((3, 3), dtype=torch.float32))


# -- tests/test_grad.py's three cases on the port, on both paths --------------


@pytest.mark.parametrize("path", sorted(PATHS))
def test_finite_difference_match(path):
    # the sphere is offset so no vertex/cell coincidence creates a
    # subgradient ambiguity at the probe points
    m = P.icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
    g = P.GridSpec((-1.43, -1.41, -1.45), 0.19, (15, 15, 15))
    cfg = P.SDFConfig(dense_max_tris=PATHS[path])
    binned = P.bin_mesh(m, g, cfg)
    w = torch.from_numpy(
        np.random.default_rng(0).standard_normal(g.shape).astype(np.float32))

    def f(verts):
        return (P.make_level_set3(m, g, cfg, binned, device=CPU, verts=verts)
                * w).sum()

    v0 = torch.from_numpy(m.verts.copy()).requires_grad_()
    f(v0).backward()
    grad = v0.grad.numpy()
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    eps = 1e-3
    for vi, ax in [(0, 0), (3, 1), (7, 2), (11, 0), (20, 1)]:
        dv = np.zeros_like(m.verts)
        dv[vi, ax] = eps
        with torch.no_grad():
            fp = float(f(torch.from_numpy(m.verts + dv)))
            fm = float(f(torch.from_numpy(m.verts - dv)))
        fd = (fp - fm) / (2 * eps)
        # float32 loss over ~3000 cells -> FD noise ~1e-2
        assert abs(fd - grad[vi, ax]) < 2e-2 * max(1.0, abs(fd)), (
            f"vertex {vi} axis {ax}: fd={fd:.5f} analytic={grad[vi, ax]:.5f}")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_gradient_of_inside_cells_points_outward(path):
    m = P.box_mesh((2, 2, 2), (-1, -1, -1))
    g = P.GridSpec((-1.6, -1.6, -1.6), 0.4, (9, 9, 9))
    cfg = P.SDFConfig(dense_max_tris=PATHS[path])
    binned = P.bin_mesh(m, g, cfg)
    v0 = torch.from_numpy(m.verts.copy()).requires_grad_()
    phi = P.make_level_set3(m, g, cfg, binned, device=CPU, verts=v0)
    val = phi[4, 4, 4]  # the box centre, inside
    val.backward()
    assert float(val.detach()) < 0
    # growing the box about its centre deepens the inside distance
    assert float((v0.grad * v0.detach()).sum()) < 0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_grad_zero_for_far_clamped_cells(path):
    m = P.box_mesh((0.5, 0.5, 0.5), (10.0, 10.0, 10.0))
    g = P.GridSpec((0.0, 0.0, 0.0), 0.5, (6, 6, 6))
    cfg = P.SDFConfig(max_passes=1, dense_max_tris=PATHS[path])
    binned = P.bin_mesh(m, g, cfg)
    v0 = torch.from_numpy(m.verts.copy()).requires_grad_()
    phi, tid = P.make_level_set3(m, g, cfg, binned, device=CPU, verts=v0,
                                 return_tid=True)
    phi.sum().backward()
    assert np.isfinite(v0.grad.numpy()).all()
    far = tid < 0
    if far.any():  # cells that hold `upper` carry no gradient
        upper = np.float32(sum(g.shape)) * np.float32(g.dx)
        assert (phi.detach()[far] == float(upper)).all()


# -- models.SDFGenerator ----------------------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sdf_generator_train_step_matches_jax(path):
    m, g, jcfg = _ico1_problem(PATHS[path])
    jmodel = JGenerator(m, g, jcfg)
    jtarget = jmodel.forward(jnp.asarray(m.verts * np.float32(0.95)))
    jnew, jloss = jmodel.train_step(jnp.asarray(m.verts), jtarget, lr=1e-2)
    jnew = np.asarray(jnew)

    jb = jmodel.binned
    pcfg = P.SDFConfig(dense_max_tris=PATHS[path])
    pg = P.GridSpec(g.origin, g.dx, g.shape)
    band = {}
    if jb.band is not None:
        csr = jb.band_csr
        band = dict(tiles_dim=jb.band.tiles_dim, pair=csr["pair"],
                    off=csr["off"], cnt=csr["cnt"], ids=csr["ids"],
                    kcap=csr["kcap"], seed_band=jb.seed_band)
    binned = ppipe.binned_from_arrays(
        pg, pcfg, tris=jb.tris, parity_packed=jb.parity_packed,
        parity_crossings=jb.parity_crossings, **band)
    model = SDFGenerator(P.Mesh(np.asarray(m.verts), m.tris), pg, pcfg,
                         device=CPU, binned=binned)
    params = model.params
    assert params.device == CPU and params.dtype == torch.float32
    new, loss = model.train_step(params, torch.from_numpy(np.asarray(jtarget)),
                                 lr=1e-2)
    assert np.isfinite(float(loss)) and float(loss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # new = v - lr * g: the gradient bar scaled by lr, plus a float32 ulp of
    # the coordinates (|v| <= 1)
    lr_g = np.abs(m.verts - jnew).max()
    np.testing.assert_allclose(new.numpy(), jnew, rtol=0,
                               atol=GRAD_JIT * lr_g + 2.4e-7)
    assert np.abs(new.numpy() - m.verts).max() > 0


def test_sdf_generator_commit_and_refresh():
    m = P.icosphere(1, radius=0.93, center=(0.013, 0.021, -0.017))
    g = P.GridSpec((-1.3, -1.3, -1.3), 2.6 / 16, (16, 16, 16))
    model = SDFGenerator(m, g, device="cpu")
    target = model.forward(model.params * 0.95).detach()
    v1, loss1 = sgd_step(model, model.params, target, 0.05)
    model.commit(v1)
    np.testing.assert_array_equal(model.mesh.verts, v1.numpy())
    _, loss2 = model.train_step(model.params, target, lr=0.05)
    assert float(loss2) < float(loss1)


def test_sdf_generator_has_no_device_mesh_yet():
    # a device mesh is a parallel.DeviceMesh (tests/test_torch_sharded.py
    # runs one); anything else is refused
    m = P.icosphere(1)
    g = P.GridSpec((-1.3, -1.3, -1.3), 2.6 / 16, (16, 16, 16))
    with pytest.raises(TypeError, match="device_mesh"):
        SDFGenerator(m, g, device="cpu", device_mesh=object())
    with pytest.raises(TypeError):
        SDFGenerator(m, g)  # the device is explicit
