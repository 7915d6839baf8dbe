"""The port's ``propagate`` and ``eikonal`` far fields and their band
(``sdfgenfast_tpu_torch.ops``: ``geometry.point_triangle_distance_sq``,
``band.band_distance_field``, ``sweep``) against the JAX package on the
CPU.

Bars and why:

- Against the JAX functions run op by op (``jax.disable_jit``): bit-equal
  (phi and ids), and the same number of plane-scan passes. The port
  rounds every operation on its own, as XLA does without fusion.
- Against the JAX functions under jit, where XLA's CPU compiler contracts
  products and sums into FMAs: the point-triangle distance rtol 2e-6;
  phi rtol 1e-5 (atol 1e-6 for cells on the surface), ids equal except at
  ties of the float64 distance (the triangles around a shared vertex).
  The plane scans hand ids on from plane to plane, so on larger grids a
  tie broken the other way can let the scans settle in another local fixed
  point (ROADMAP queue 3); on this test's grid every differing id is a tie.
- The point-triangle distance against the float64 oracle
  (``tests/oracle.py``), zero-area triangles against closed forms: the
  reference's formula reads a point or segment triangle with a repeated
  vertex as its vertex c (the clamped determinant zeroes both plane
  weights), as the oracle does (ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import brute_force_sdf, point_triangle_distance_np
from sdfgenfast_tpu.grid import sizing_mode2a_proportional
from sdfgenfast_tpu.mesh import icosphere
from sdfgenfast_tpu.ops import band as jband
from sdfgenfast_tpu.ops import geometry as jgeom
from sdfgenfast_tpu.ops import sweep as jsweep
from sdfgenfast_tpu_torch.ops import band as pband
from sdfgenfast_tpu_torch.ops import geometry as pgeom
from sdfgenfast_tpu_torch.ops import sweep as psweep

RTOL, ATOL = 1e-5, 1e-6

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def test_point_triangle_distance_sq_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    n = 20000
    p = rng.normal(size=(n, 3)).astype(np.float32)
    tri = rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.5
    args = (p, tri[:, 0], tri[:, 1], tri[:, 2])
    got = pgeom.point_triangle_distance_sq(
        *(torch.from_numpy(a) for a in args)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jgeom.point_triangle_distance_sq(
            *(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got.view(np.int32), eager.view(np.int32))
    jitted = np.asarray(jax.jit(jgeom.point_triangle_distance_sq)(
        *(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, jitted, rtol=2e-6, atol=1e-7)
    exact = point_triangle_distance_np(*(a.astype(np.float64) for a in args))
    np.testing.assert_allclose(np.sqrt(got), exact, rtol=2e-5, atol=2e-6)
    # the stacked form is the SoA form's expression
    soa = pgeom.point_triangle_distance_sq_soa(
        *(tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in
                range(3)) for a in args)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), soa.view(np.int32))


def test_point_triangle_distance_sq_zero_area():
    """A triangle with a repeated vertex is read as its vertex c: the
    clamped determinant zeroes both plane weights, so the plane case holds
    with all the weight on c. point_segment_distance_sq is the segment's
    distance."""
    rng = np.random.default_rng(1)
    n = 2000
    p = rng.normal(size=(n, 3)).astype(np.float32)
    a = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    b = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    to_b = ((p - b).astype(np.float64) ** 2).sum(1)
    for tri in ((b, b, b), (a, b, b), (a, a, b), (b, a, b)):
        got = pgeom.point_triangle_distance_sq(
            *(torch.from_numpy(x) for x in (p,) + tri)).numpy()
        np.testing.assert_allclose(got, to_b, rtol=2e-5, atol=1e-7)
        jax_d = np.asarray(jgeom.point_triangle_distance_sq(
            *(jnp.asarray(x) for x in (p,) + tri)))
        np.testing.assert_allclose(got, jax_d, rtol=2e-6, atol=1e-7)
    p64, a64, b64 = (x.astype(np.float64) for x in (p, a, b))
    t = np.clip(((p64 - a64) * (b64 - a64)).sum(1)
                / ((b64 - a64) ** 2).sum(1), 0.0, 1.0)
    seg = ((p64 - (a64 + t[:, None] * (b64 - a64))) ** 2).sum(1)
    seg_p = pgeom.point_segment_distance_sq(
        *(torch.from_numpy(x) for x in (p, a, b))).numpy()
    seg_j = np.asarray(jgeom.point_segment_distance_sq(
        jnp.asarray(p), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(seg_p, seg_j, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(seg_p, seg, rtol=2e-5, atol=1e-7)


def test_argmin_takes_the_first_minimum():
    """plane_update and band_distance_field rely on torch.argmin returning
    the first of equal minima, as jnp.argmin does, also when every entry is
    inf (no valid candidate)."""
    x = np.array([[3.0, 1.0, 1.0, 2.0], [np.inf] * 4, [5.0, 5.0, 5.0, 5.0],
                  [np.inf, 2.0, np.inf, 2.0]], np.float32)
    got = torch.argmin(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmin(x, axis=-1)))
    np.testing.assert_array_equal(got, [1, 0, 0, 1])
    big = np.full((9, 33, 70), np.inf, np.float32)
    big[3:7, ::2] = 1.5
    np.testing.assert_array_equal(
        torch.argmin(torch.from_numpy(big), dim=0).numpy(),
        np.asarray(jnp.argmin(big, axis=0)))


def test_shift_planes_match_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(-1, 50, (7, 11)).astype(np.int32)
    got = psweep._shift_planes(torch.from_numpy(x), -1).numpy()
    want = np.stack([np.asarray(jsweep._shift_plane(jnp.asarray(x), dj, dk,
                                                     jnp.int32(-1)))
                     for dj, dk in jsweep._SHIFTS])
    np.testing.assert_array_equal(got, want)


def _plane_case(seed):
    rng = np.random.default_rng(seed)
    m, B, C = 40, 6, 9
    tv = rng.normal(size=(m, 3, 3)).astype(np.float32)
    cand = rng.integers(-1, m, (9, B, C)).astype(np.int32)
    cand[:, 0, :] = -1  # a row of cells with no valid candidate
    # tied candidates: the same triangle twice; and in a row of its own,
    # two copies of one triangle under different ids, nothing else
    cand[4, 1, :] = cand[2, 1, :] = 7
    tv[8] = tv[7]
    cand[:, 2, :] = -1
    cand[5, 2, :] = 8
    cand[6, 2, :] = 7
    gx = rng.normal(size=(1, B, C, 3)).astype(np.float32)
    cur_phi = np.abs(rng.normal(size=(B, C))).astype(np.float32) * 3
    cur_phi[2] = np.inf
    cur_tid = rng.integers(-1, m, (B, C)).astype(np.int32)
    return cand, cur_phi, cur_tid, tv, gx


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_update_matches_jax(seed):
    args = _plane_case(seed)
    got = psweep.plane_update(*(torch.from_numpy(a) for a in args))
    with jax.disable_jit():
        eager = jsweep.plane_update(*(jnp.asarray(a) for a in args))
    jitted = jax.jit(jsweep.plane_update)(*(jnp.asarray(a) for a in args))
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jitted[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jitted[1]))
    cand, cur_phi, cur_tid = args[:3]
    phi, tid = (g.numpy() for g in got)
    # no valid candidate: the cell keeps its values
    np.testing.assert_array_equal(phi[0], cur_phi[0])
    np.testing.assert_array_equal(tid[0], cur_tid[0])
    # an exact tie: the first of the tied candidates in _SHIFTS order
    assert (tid[2] == 8).all()


@pytest.fixture(scope="module")
def seeds():
    """band_distance_field seeds (propagate/eikonal binning: the band
    itself, unpruned) for icosphere(2) on an 18^3 grid, from both packages
    op by op and from the JAX package under jit."""
    mesh = icosphere(2, radius=1.0, center=(0.05, -0.03, 0.06))
    grid = sizing_mode2a_proportional(*mesh.bounds(), 18, 1)
    bb = jband.bin_triangles(mesh.verts, mesh.tris, grid, 1, (8, 8, 8),
                             prune=False)
    tv = mesh.verts[mesh.tris.astype(np.int64)]
    origin = np.asarray(grid.origin, np.float32)
    dx = np.float32(grid.dx)
    arrays = (tv, bb.active_ids, bb.cand, bb.cand_valid, origin)
    kw = dict(tile_shape=(8, 8, 8), tiles_dim=bb.tiles_dim,
              grid_shape=grid.shape)
    jargs = tuple(jnp.asarray(a) for a in arrays) + (jnp.float32(dx),)
    with jax.disable_jit():
        eager = jband.band_distance_field(*jargs, **kw)
    jitted = jband.band_distance_field(*jargs, **kw)
    port = pband.band_distance_field(
        *(torch.from_numpy(a) for a in arrays), float(dx), kw["tile_shape"],
        kw["tiles_dim"], kw["grid_shape"], chunk=4)
    return dict(mesh=mesh, grid=grid, tv=tv, origin=origin, dx=dx,
                eager=[np.array(x) for x in eager],
                jitted=[np.array(x) for x in jitted],
                port=[x.numpy() for x in port])


def _ids_tie(s, cells_mask, tid_a, tid_b, rtol=RTOL, atol=ATOL):
    """Where the ids differ (in `cells_mask`), both ids' float64 distances
    from the float32 world cell positions tie to (rtol, atol)."""
    mism = (tid_a != tid_b) & cells_mask
    if not mism.any():
        return mism
    idx = np.argwhere(mism)
    p = (idx.astype(np.float32) * s["dx"] + s["origin"]).astype(np.float64)
    tl = s["tv"].astype(np.float64)
    a, b = tid_a[mism], tid_b[mism]
    da = point_triangle_distance_np(p, tl[a, 0], tl[a, 1], tl[a, 2])
    db = point_triangle_distance_np(p, tl[b, 0], tl[b, 1], tl[b, 2])
    np.testing.assert_allclose(da, db, rtol=rtol, atol=atol,
                               err_msg="ids differ at a non-tie")
    return mism


def test_band_distance_field_matches_jax(seeds):
    s = seeds
    (phi, tid), (ephi, etid), (jphi, jtid) = (s["port"], s["eager"],
                                              s["jitted"])
    np.testing.assert_array_equal(phi.view(np.int32), ephi.view(np.int32))
    np.testing.assert_array_equal(tid, etid)
    np.testing.assert_allclose(phi, jphi, rtol=RTOL, atol=ATOL)
    _ids_tie(s, np.ones(tid.shape, bool), tid, jtid)
    upper = np.float32(sum(s["grid"].shape)) * s["dx"]
    assert (phi[tid < 0] == upper).all() and (tid >= 0).any()
    # the band is exact where seeded: the oracle's distance
    ref = np.abs(brute_force_sdf(s["mesh"].verts, s["mesh"].tris,
                                 s["grid"].origin, s["dx"], s["grid"].shape))
    near = (tid >= 0) & (ref < s["dx"])
    np.testing.assert_allclose(phi[near], ref[near], rtol=5e-5, atol=2e-6)


def _jax_passes(s, phi0, tid0, full):
    """The number of passes JAX's jitted while_loop runs: the first k after
    which the state equals the converged one, plus the pass that found no
    change."""
    args = (jnp.asarray(phi0), jnp.asarray(tid0), jnp.asarray(s["tv"]),
            jnp.asarray(s["origin"]), jnp.float32(s["dx"]))
    for k in range(1, 64):
        phi, _ = jsweep.propagate_closest_triangles(*args, max_passes=k)
        if np.array_equal(np.asarray(phi), full):
            return k + 1
    return 64


def test_propagate_matches_jax(seeds):
    s = seeds
    phi0, tid0 = s["eager"]
    args = (s["tv"], s["origin"])
    phi, tid, passes = psweep.propagate_closest_triangles(
        torch.from_numpy(phi0.copy()), torch.from_numpy(tid0.copy()),
        *(torch.from_numpy(a) for a in args), float(s["dx"]), max_passes=64)
    phi, tid = phi.numpy(), tid.numpy()
    jargs = (jnp.asarray(phi0), jnp.asarray(tid0),
             *(jnp.asarray(a) for a in args), jnp.float32(s["dx"]))
    with jax.disable_jit():
        ephi, etid = jsweep.propagate_closest_triangles(*jargs,
                                                        max_passes=64)
    np.testing.assert_array_equal(phi.view(np.int32),
                                  np.asarray(ephi).view(np.int32))
    np.testing.assert_array_equal(tid, np.asarray(etid))
    # one pass fewer stops before the fixed point is confirmed: the same
    # state, so the port's last pass changed nothing, as JAX's loop
    # requires; and one pass more than that is JAX's count, op by op
    if passes > 1:
        before, _, _ = psweep.propagate_closest_triangles(
            torch.from_numpy(phi0.copy()), torch.from_numpy(tid0.copy()),
            *(torch.from_numpy(a) for a in args), float(s["dx"]),
            max_passes=passes - 1)
        np.testing.assert_array_equal(before.numpy(), phi)
    jphi, jtid = (np.asarray(x) for x in
                  jsweep.propagate_closest_triangles(*jargs, max_passes=64))
    assert _jax_passes(s, phi0, tid0, jphi) == passes
    assert passes >= 2 and (tid >= 0).all()
    # under jit: phi rtol 1e-5, ids equal except at ties
    np.testing.assert_allclose(phi, jphi, rtol=RTOL, atol=ATOL)
    _ids_tie(s, np.ones(tid.shape, bool), tid, jtid)
    ref = np.abs(brute_force_sdf(s["mesh"].verts, s["mesh"].tris,
                                 s["grid"].origin, s["dx"], s["grid"].shape))
    assert (phi >= ref * (1 - RTOL) - ATOL).all()


@pytest.mark.parametrize("iters", [0, 1, 36])
def test_eikonal_matches_jax(seeds, iters):
    s = seeds
    phi0, tid0 = s["eager"]
    frozen = tid0 >= 0
    got = psweep.eikonal_far_field(torch.from_numpy(phi0.copy()),
                                   torch.from_numpy(frozen), float(s["dx"]),
                                   iters).numpy()
    jargs = (jnp.asarray(phi0), jnp.asarray(frozen), jnp.float32(s["dx"]))
    with jax.disable_jit():
        eager = np.asarray(jsweep.eikonal_far_field_impl(*jargs, iters))
    np.testing.assert_array_equal(got.view(np.int32), eager.view(np.int32))
    jitted = np.asarray(jsweep.eikonal_far_field(*jargs, iters))
    np.testing.assert_allclose(got, jitted, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[frozen], phi0[frozen])
    if iters == 36:  # 2 * max(n): every cell reached, within 2 dx
        ref = np.abs(brute_force_sdf(s["mesh"].verts, s["mesh"].tris,
                                     s["grid"].origin, s["dx"],
                                     s["grid"].shape))
        assert np.abs(got - ref).max() < 2 * s["dx"]


def test_sort3_is_a_sort():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 1000)).astype(np.float32)
    x[:, :50] = np.inf
    x[1, 50:100] = x[0, 50:100]
    got = np.stack([t.numpy() for t in psweep._sort3(
        *(torch.from_numpy(v) for v in x))])
    np.testing.assert_array_equal(got, np.sort(x, axis=0))
