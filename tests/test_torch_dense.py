"""The PyTorch port's dense path (kernel K1: its plain twin on the CPU)
against the JAX package, the float64 oracle and the reference
binary's box goldens, plus the batch API.

The JAX side runs ``sdfgenfast_tpu.ops.dense.dense_distance_field`` in
Pallas interpret mode on the CPU, as tests/test_dense.py does. Bars, port vs
JAX: phi within rtol 2e-6 / atol 1e-6 (XLA contracts products and sums into
FMAs under jit, the port rounds every operation on its own, as the CUDA
kernels built with --fmad=false do); ids equal except where the two ids'
float64 distances tie to that same bar."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfgenfast_tpu as J
import sdfgenfast_tpu_torch as P
from sdfgenfast_tpu.ops import dense as jdense
from sdfgenfast_tpu.ops import geometry as jgeom
from sdfgenfast_tpu_torch import grid as pgrid
from sdfgenfast_tpu_torch import tracing
from sdfgenfast_tpu_torch import pipeline as ppipe
from sdfgenfast_tpu_torch.io import mesh_io, sdf_io
from sdfgenfast_tpu_torch.ops import dense as pdense
from sdfgenfast_tpu_torch.ops import geometry as pgeom
from sdfgenfast_tpu_torch.ops.vdt import sqrt_f32

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle import brute_force_sdf, point_triangle_distance_np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
RTOL, ATOL = 2e-6, 1e-6

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _tri_verts(mesh, tris=None):
    tris = mesh.tris if tris is None else tris
    return mesh.verts[tris.astype(np.int64)]


def _both(tv, origin, dx, gs, off=None):
    """(JAX phi, JAX tid, port phi, port tid) as NumPy arrays."""
    origin = np.asarray(origin, np.float32)
    pj, tj = jdense.dense_distance_field(
        jnp.asarray(tv), jnp.asarray(origin), jnp.float32(dx), grid_shape=gs,
        ijk_offset=None if off is None else jnp.asarray(off, jnp.int32))
    pp, tp = pdense.dense_distance_field(torch.from_numpy(tv), origin, dx,
                                         grid_shape=gs, ijk_offset=off)
    return np.asarray(pj), np.asarray(tj), pp.numpy(), tp.numpy()


def _assert_ids_tie(tv, origin, dx, gs, off, tid_a, tid_b):
    """Where the ids differ, both ids' exact distances (float64, from the
    float32 grid-local triangles and cell positions) tie to the phi bar."""
    mism = (tid_a != tid_b).reshape(-1)
    if not mism.any():
        return
    o = np.zeros(3, np.int64) if off is None else np.asarray(off, np.int64)
    idx = np.stack(np.meshgrid(*[np.arange(n) for n in gs], indexing="ij"),
                   -1).reshape(-1, 3)[mism] + o
    p = (idx.astype(np.float32) * np.float32(dx)).astype(np.float64)
    tl = (tv - np.asarray(origin, np.float32)).astype(np.float64)
    a, b = tid_a.reshape(-1)[mism], tid_b.reshape(-1)[mism]
    da = point_triangle_distance_np(p, tl[a, 0], tl[a, 1], tl[a, 2])
    db = point_triangle_distance_np(p, tl[b, 0], tl[b, 1], tl[b, 2])
    np.testing.assert_allclose(da, db, rtol=RTOL, atol=ATOL,
                               err_msg="ids differ at a non-tie")


def _ico1(off=0.0):
    return P.icosphere(1, radius=1.0,
                       center=(off + 0.05, off - 0.03, off + 0.08))


def _ico3():
    return P.icosphere(3, radius=1.0, center=(0.02, -0.01, 0.03))


# -- geometry ---------------------------------------------------------------


def test_point_triangle_distance_sq_soa_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(3, 2000)).astype(np.float32)
    tri = rng.normal(size=(3, 3, 2000)).astype(np.float32)
    tri[:, :, :100] = tri[0:1, :, :100]  # zero-area: a point
    tri[2, :, 100:200] = tri[1, :, 100:200]  # a segment
    args = (p, tri[0], tri[1], tri[2])
    want = np.asarray(jgeom.point_triangle_distance_sq_soa(
        *(tuple(jnp.asarray(v) for v in x) for x in args)))
    got = pgeom.point_triangle_distance_sq_soa(
        *(tuple(torch.from_numpy(v) for v in x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    exact = point_triangle_distance_np(
        p.T.astype(np.float64), *(tri[i].T.astype(np.float64) for i in range(3)))
    np.testing.assert_allclose(np.sqrt(got), exact, rtol=2e-5, atol=2e-6)


# -- the coefficient table ----------------------------------------------------

# (subdivision, centre, grid origin): icosphere(1) and (3) near the world
# origin and icosphere(1) 1000 units from it
TABLE_MESHES = [
    (1, (0.05, -0.03, 0.08), (-1.31, -1.24, -1.18)),
    (3, (0.02, -0.01, 0.03), (-1.2, -1.15, -1.1)),
    (1, (1000.05, 999.97, 1000.08), (998.69, 998.76, 998.82)),
]


def _table_mesh(sub, center):
    """(verts (N, 3) f32, tris (M, 3) int32): the icosphere's first 384
    triangles, the first made zero-area."""
    mesh = P.icosphere(sub, radius=1.0, center=center)
    tris = mesh.tris[:384].astype(np.int32)
    tris[0] = tris[0, 0]
    return np.ascontiguousarray(mesh.verts, np.float32), tris


@pytest.mark.parametrize("sub,center,origin", TABLE_MESHES)
def test_sep_coefs_match_jax(sub, center, origin):
    tl = (_tri_verts(P.icosphere(sub, radius=1.0, center=center))[:384]
          - np.asarray(origin, np.float32))
    tl[0] = tl[0, 0]  # a zero-area triangle: degenerate flag, row 39
    got = pdense._sep_coefs(torch.from_numpy(tl)).numpy()
    assert got.shape == (40, len(tl)) and got[39, 0] == 1.0
    # JAX's table evaluated one operation at a time: bit-equal
    with jax.disable_jit():
        eager = np.asarray(jdense._sep_coefs(jnp.asarray(tl)))
    np.testing.assert_array_equal(got.view(np.int32), eager.view(np.int32))
    # as its dense path computes it, under jit: rows 0-14 (differences of
    # vertices) and 39 (the flag) bit-equal; the rest within 8 ulps of each
    # row's largest magnitude, because XLA's CPU compiler contracts a*b+c
    # into FMAs and rewrites x/sqrt(y) under jit
    jitted = np.asarray(jax.jit(jdense._sep_coefs)(jnp.asarray(tl)))
    for r in list(range(15)) + [39]:
        np.testing.assert_array_equal(got[r], jitted[r], err_msg=f"row {r}")
    scale = np.spacing(np.abs(jitted).max(axis=1))
    assert (np.abs(got - jitted).max(axis=1) <= 8 * scale).all()


@pytest.mark.parametrize("form", ["gather-fused", "pre-gathered"])
@pytest.mark.parametrize("sub,center,origin", TABLE_MESHES)
def test_sep_table_matches_jax(sub, center, origin, form):
    """The wrapper's two entries on CPU tensors (the mesh's vertices and
    int32 triangles, or the gathered corners), the origin subtracted inside,
    bit-equal to JAX's table of the same corners less the same origin."""
    verts, tris = _table_mesh(sub, center)
    tl = verts[tris.astype(np.int64)] - np.asarray(origin, np.float32)
    with jax.disable_jit():
        want = np.asarray(jdense._sep_coefs(jnp.asarray(tl)))
    v = torch.from_numpy(verts)
    before = pdense.sep_table.launches
    if form == "gather-fused":
        got = pdense.sep_table(v, torch.tensor(origin), torch.from_numpy(tris))
    else:
        got = pdense.sep_table(v[torch.from_numpy(tris).long()], list(origin))
    assert pdense.sep_table.launches == before  # the twin launches nothing
    assert got.shape == (40, len(tris)) and got.is_contiguous()
    assert float(got[39, 0]) == 1.0
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


_BAD_TABLE_INPUTS = {
    "tris int64": lambda v, t: (v, t.long()),
    "tris uint8": lambda v, t: (v, t.to(torch.uint8)),
    "tris (M, 2)": lambda v, t: (v, t[:, :2].contiguous()),
    "verts (N, 2)": lambda v, t: (v[:, :2].contiguous(), t),
    "verts float64": lambda v, t: (v.double(), t),
    "1025 triangles": lambda v, t: (v, t[torch.arange(1025) % len(t)]),
    "gathered (M, 3, 2)": lambda v, t: (v[t.long()][:, :, :2], None),
    "gathered 1025": lambda v, t: (v[t.long()][torch.arange(1025) % len(t)],
                                   None),
}


@pytest.mark.parametrize("case", sorted(_BAD_TABLE_INPUTS))
def test_sep_table_refuses_bad_inputs(case):
    verts, tris = (torch.from_numpy(x)
                   for x in _table_mesh(*TABLE_MESHES[0][:2]))
    verts, tris = _BAD_TABLE_INPUTS[case](verts, tris)
    with pytest.raises(ValueError, match="1024" if "1025" in case else None):
        pdense.sep_table(verts, (0.0, 0.0, 0.0), tris)


def test_sep_table_counter_in_launch_count(monkeypatch):
    """``sep_table.launches`` is one of ``tracing.launch_count``'s
    counters, so a span around the table counts its launch."""
    monkeypatch.setattr(pdense.sep_table, "launches", 11)
    before = tracing.launch_count()
    pdense.sep_table.launches += 1
    assert tracing.launch_count() == before + 1
    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("sdf.dense.table"):
            pdense.sep_table.launches += 1
    finally:
        tracing.disable()
    (rec,) = [r for r in tracing.spans() if r.name == "sdf.dense.table"]
    assert rec.launches == 1
    tracing.clear()


# -- the twins against the JAX kernels and the oracle -----------------------


def _case(name):
    """(tri_verts, origin, dx, grid_shape, ijk_offset, oracle rtol/atol)."""
    ico1 = _tri_verts(_ico1())
    o1 = (-1.31, -1.24, -1.18)
    if name == "ico1":
        return ico1, o1, 0.17, (14, 17, 19), None, (2e-5, 2e-6)
    if name == "ico1_offset":
        return ico1, o1, 0.17, (9, 8, 7), (3, 5, 6), (2e-5, 2e-6)
    if name == "ico1_at_1000":
        return (_tri_verts(_ico1(1000.0)), (998.69, 998.76, 998.82), 0.17,
                (14, 17, 19), None, (2e-4, 2e-4))
    # zero-area triangles: the oracle's barycentric branch does not hold
    # for them, test_degenerate_triangle_values checks their values
    if name == "point":
        return (np.full((1, 3, 3), 0.5, np.float32), (0, 0, 0), 0.1,
                (10, 10, 10), None, None)
    if name == "segment":
        return (np.asarray([[[0.2, 0.5, 0.5], [0.8, 0.5, 0.5],
                             [0.8, 0.5, 0.5]]], np.float32), (0, 0, 0), 0.1,
                (10, 10, 10), None, None)
    m = _ico3()
    if name == "ico3_512":  # a streamed table
        return (_tri_verts(m, m.tris[:512]), (-1.2, -1.15, -1.1), 0.24,
                (9, 10, 11), None, (2e-5, 2e-6))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ico1", "ico1_offset", "ico1_at_1000",
                                  "point", "segment", "ico3_512"])
def test_dense_matches_jax_and_oracle(name):
    tv, origin, dx, gs, off, oracle_tol = _case(name)
    pj, tj, pp, tp = _both(tv, origin, dx, gs, off)
    assert pp.shape == gs and pp.dtype == np.float32 and tp.dtype == np.int32
    np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)
    _assert_ids_tie(tv, origin, dx, gs, off, tj, tp)
    assert (tp >= 0).all() and (tp < len(tv)).all()
    if oracle_tol is None:
        return
    # the float64 oracle on the grid's world positions (offset included)
    o = np.zeros(3) if off is None else np.asarray(off)
    world = np.float32(origin) + np.float32(o) * np.float32(dx)
    verts = tv.reshape(-1, 3)
    ref = np.abs(brute_force_sdf(verts, np.arange(len(verts)).reshape(-1, 3),
                                 world, dx, gs))
    np.testing.assert_allclose(pp, ref, rtol=oracle_tol[0], atol=oracle_tol[1])


def test_degenerate_triangle_values():
    tv, origin, dx, gs, _, _ = _case("point")
    phi, tid = pdense.dense_distance_field(torch.from_numpy(tv), origin, dx,
                                           grid_shape=gs)
    idx = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"), -1)
    np.testing.assert_allclose(phi.numpy(),
                               np.linalg.norm(idx * 0.1 - 0.5, axis=-1),
                               rtol=1e-5, atol=1e-6)
    assert (tid.numpy() == 0).all()
    tv, origin, dx, gs, _, _ = _case("segment")
    phi, _ = pdense.dense_distance_field(torch.from_numpy(tv), origin, dx,
                                         grid_shape=gs)
    # (0.5, 0.5, 0.5) lies on the segment; (0.5, 0.5, 0.8) is 0.3 off it
    assert float(phi[5, 5, 5]) < 1e-6
    np.testing.assert_allclose(float(phi[5, 5, 8]), 0.3, rtol=1e-5)


@pytest.mark.parametrize("m,kernel", [(384, "stream"), (385, "stream"),
                                      (1024, "stream")])
def test_gate_selects_kernel_and_matches_jax(m, kernel, monkeypatch):
    """One dense kernel on both sides of the JAX package's 384-triangle
    gate and at the cap."""
    mesh = _ico3()
    tv = _tri_verts(mesh, mesh.tris[:m])
    origin, dx, gs = (-1.2, -1.15, -1.1), 0.5, (5, 6, 7)
    called = []
    fn = pdense.dense_stream
    monkeypatch.setattr(
        pdense, "dense_stream",
        lambda *a, **k: called.append("stream") or fn(*a, **k))
    pj, tj, pp, tp = _both(tv, origin, dx, gs)
    assert called == [kernel]
    np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)
    _assert_ids_tie(tv, origin, dx, gs, None, tj, tp)


def test_gate_rejects_above_cap():
    mesh = P.icosphere(3)
    tv = torch.from_numpy(_tri_verts(mesh, mesh.tris[:1025]))
    with pytest.raises(ValueError, match="1024"):
        pdense.dense_distance_field(tv, (0, 0, 0), 0.1, grid_shape=(4, 4, 4))
    with pytest.raises(ValueError):
        pdense.dense_distance_field(tv[:10].double(), (0, 0, 0), 0.1,
                                    grid_shape=(4, 4, 4))


def test_twins_agree_on_one_mesh():
    """K1's wrapper on CPU tensors is dense_sep_reference, bit for bit, and
    the separable formulation agrees with the per-triangle point-triangle
    distance (the formulation of the JAX package's _dense_kernel) to the
    JAX bar."""
    mesh = _ico3()
    tl = torch.from_numpy(_tri_verts(mesh, mesh.tris[:200])
                          - np.float32([-1.2, -1.15, -1.1]))
    kw = dict(grid_shape=(7, 8, 9), ijk_offset=(1, 0, 2))
    coef = pdense._sep_coefs(tl)
    pr, tr = pdense.dense_sep_reference(coef, 0.3, **kw)
    ps, ts = pdense.dense_stream(coef, 0.3, **kw)
    assert torch.equal(ps, pr) and torch.equal(ts, tr)
    p = pdense._cell_axes(kw["grid_shape"], 0.3, kw["ijk_offset"], CPU)
    d2 = torch.stack([pgeom.point_triangle_distance_sq_soa(
        p, *(tuple(tl[t, v]) for v in range(3))) for t in range(len(tl))])
    np.testing.assert_allclose(ps.numpy(), np.sqrt(d2.min(0).values.numpy()),
                               rtol=RTOL, atol=ATOL)
    assert pdense.dense_stream.launches == 0


def test_stream_range_matches_jax_dense_kernel():
    """The port's dense path at 1024 triangles (a streamed table: the
    separable formulation, dense_stream's twin on the CPU) against the JAX package's
    _dense_impl, which takes its per-triangle _dense_kernel there (Pallas
    interpret mode), on the torus the smoke runs, on a grid away from the
    origin with an index offset."""
    tv = _tri_verts(P.torus_mesh(32, 16))
    assert len(tv) == 1024
    origin, dx, gs, off = (-1.93, -1.71, -0.62), 0.12, (24, 26, 12), (3, 2, 1)
    pj, tj, pp, tp = _both(tv, origin, dx, gs, off)
    np.testing.assert_allclose(pp, pj, rtol=RTOL, atol=ATOL)
    _assert_ids_tie(tv, origin, dx, gs, off, tj, tp)
    assert (tp >= 0).all() and (tp < len(tv)).all()


# -- the pipeline ---------------------------------------------------------


@pytest.mark.parametrize("transport", ["auto", "packed", "crossings"])
def test_dense_bin_mesh_parity_byte_equal(transport):
    mesh = P.icosphere(2, radius=1.0, center=(0.1, -0.05, 0.07))
    grid = pgrid.GridSpec((-1.5, -1.5, -1.5), 0.14, (22, 23, 24))
    bj = J.bin_mesh(J.Mesh(mesh.verts, mesh.tris),
                    J.GridSpec(grid.origin, grid.dx, grid.shape),
                    J.SDFConfig(parity_transport=transport))
    bp = P.bin_mesh(mesh, grid, P.SDFConfig(parity_transport=transport))
    assert bj.band is None and bp.band_csr is None and bp.tiles_dim is None
    np.testing.assert_array_equal(bp.tris, bj.tris)
    for name in ("parity_packed", "parity_crossings"):
        a, b = getattr(bp, name), getattr(bj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.fixture(scope="module")
def ico2_run():
    pmesh = P.icosphere(2, radius=1.0, center=(0.1, -0.05, 0.07))
    grid = pgrid.GridSpec((-1.5, -1.5, -1.5), 0.14, (22, 23, 24))
    jgrid = J.GridSpec(grid.origin, grid.dx, grid.shape)
    jmesh = J.Mesh(pmesh.verts, pmesh.tris)
    jb = J.bin_mesh(jmesh, jgrid, J.SDFConfig())
    jphi, jtid = J.make_level_set3(jmesh, jgrid, J.SDFConfig(), binned=jb,
                                   return_tid=True)
    binned = ppipe.binned_from_arrays(
        grid, P.SDFConfig(), tris=jb.tris, parity_packed=jb.parity_packed,
        parity_crossings=jb.parity_crossings)
    phi, tid = P.make_level_set3(pmesh, grid, binned=binned, device=CPU,
                                 return_tid=True)
    return dict(mesh=pmesh, grid=grid, jphi=np.asarray(jphi),
                jtid=np.asarray(jtid), phi=phi.numpy(), tid=tid.numpy())


def test_make_level_set3_dense_matches_jax(ico2_run):
    r = ico2_run
    phi, jphi = r["phi"], r["jphi"]
    assert phi.shape == r["grid"].shape
    off_surface = np.minimum(np.abs(phi), np.abs(jphi)) > 1e-5
    assert (((phi < 0) != (jphi < 0)) & off_surface).sum() == 0
    np.testing.assert_allclose(phi, jphi, rtol=RTOL, atol=ATOL)
    tv = _tri_verts(r["mesh"])
    _assert_ids_tie(tv, r["grid"].origin, r["grid"].dx, r["grid"].shape,
                    None, r["jtid"], r["tid"])


def test_make_level_set3_dense_own_binning(ico2_run):
    r = ico2_run
    phi = P.make_level_set3(r["mesh"], r["grid"], device=CPU).numpy()
    np.testing.assert_array_equal(phi.view(np.int32), r["phi"].view(np.int32))


def test_dense_equals_binned_path(ico2_run):
    r = ico2_run
    binned = P.make_level_set3(r["mesh"], r["grid"],
                               P.SDFConfig(dense_max_tris=0),
                               device=CPU).numpy()
    phi = r["phi"]
    off_surface = np.minimum(np.abs(phi), np.abs(binned)) > 1e-5
    assert (((phi < 0) != (binned < 0)) & off_surface).sum() == 0
    np.testing.assert_allclose(phi, binned, atol=0.05 * r["grid"].dx)


def test_dense_far_field_matches_oracle():
    mesh = P.box_mesh((3, 4, 5), (-1, -1, -1))
    grid = pgrid.GridSpec((-1.5, -1.5, -1.5), 0.5, (14, 16, 18))
    phi = P.make_level_set3(mesh, grid, device=CPU).numpy()
    ref, parity = brute_force_sdf(mesh.verts, mesh.tris, grid.origin, grid.dx,
                                  grid.shape, return_parity=True)
    np.testing.assert_allclose(np.abs(phi), np.abs(ref), rtol=5e-5, atol=2e-6)
    assert ((phi < 0) == parity)[np.abs(ref) > 1e-5].all()


def test_dense_binned_without_band_rejected_on_binned_path():
    mesh = P.box_mesh((1, 2, 3))
    grid = pgrid.GridSpec((-0.5, -0.5, -0.5), 0.25, (8, 12, 16))
    dense = P.bin_mesh(mesh, grid)
    with pytest.raises(ValueError, match="band"):
        P.make_level_set3(mesh, grid, P.SDFConfig(dense_max_tris=0), dense,
                          device=CPU)
    with pytest.raises(ValueError):
        ppipe.binned_from_arrays(grid, P.SDFConfig(), tris=dense.tris,
                                 tiles_dim=(1, 2, 2),
                                 parity_packed=dense.parity_packed)


# -- the reference binary's box goldens, on the CPU ---------------------------


with open(os.path.join(HERE, "goldens", "manifest.json")) as _fh:
    MANIFEST = json.load(_fh)
BOX_GOLDENS = sorted(k for k in MANIFEST if k.startswith("box_"))


def golden_grid(name):
    """The CLI's sizing of a manifest entry (tests/test_parity_golden.py)."""
    entry = MANIFEST[name]
    mesh, mn, mx = mesh_io.load_mesh(os.path.join(HERE, "resources",
                                                  entry["mesh"]))
    cli = entry["cli_args"]
    if entry["mesh"].endswith(".stl"):
        if len(cli) >= 5:
            grid = pgrid.sizing_mode2b_manual(mn, mx, *map(int, cli[:4]))
        else:
            grid = pgrid.sizing_mode2a_proportional(mn, mx, int(cli[0]),
                                                    int(cli[1]))
    else:
        grid = pgrid.sizing_mode1_legacy(mn, mx, float(cli[0]), int(cli[1]))
    return mesh, grid, entry


def assert_golden_bars(phi, grid, entry):
    """The bars of tests/test_parity_golden.py."""
    golden, gmin, _ = sdf_io.read_sdf(os.path.join(HERE, "goldens",
                                                   entry["golden"]))
    assert phi.shape == golden.shape == grid.shape
    np.testing.assert_allclose(grid.bounds_min, gmin,
                               atol=2e-6 * max(abs(gmin).max(), 1))
    surf = np.minimum(np.abs(phi), np.abs(golden)) < 1e-5
    assert (((phi < 0) != (golden < 0)) & ~surf).sum() == 0
    near = np.abs(golden) < 2 * grid.dx
    np.testing.assert_allclose(np.abs(phi)[near], np.abs(golden)[near],
                               rtol=5e-5, atol=2e-6)
    assert np.abs(np.abs(phi) - np.abs(golden)).max() < 0.2 * grid.dx


@pytest.mark.parametrize("name", BOX_GOLDENS)
def test_box_golden_dense_cpu(name):
    mesh, grid, entry = golden_grid(name)
    assert ppipe.use_dense(P.SDFConfig(), mesh.num_tris)
    assert_golden_bars(P.make_level_set3(mesh, grid, device=CPU).numpy(),
                       grid, entry)


# -- the batch API --------------------------------------------------------


def test_generate_sdf_batch_equals_single_calls():
    box = P.box_mesh((3, 4, 5), (-1.5, -2, -2.5))
    torus = P.torus_mesh(8, 6, R=1.5, r=0.5)
    sphere = P.icosphere(3, radius=1.8)  # 1280 triangles: the binned path
    meshes = [(m.verts, m.tris) for m in (box, torus, sphere)]
    args = ((-2.5, -3.0, -3.5), 0.25, 21, 25, 29)
    out = P.generate_sdf_batch(meshes, *args, backend="cpu")
    assert len(out) == 3
    for (v, t), got in zip(meshes, out):
        want = P.generate_sdf(v, t, *args, backend="cpu")
        assert got.dtype == np.float32 and got.shape == (21, 25, 29)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert P.generate_sdf_batch([], *args, backend="cpu") == []


def test_generate_sdf_batch_errors():
    box = P.box_mesh((1, 2, 3))
    ok = [(box.verts, box.tris)]
    args = ((0, 0, 0), 0.25, 8, 8, 8)
    for bad in (((0, 0, 0), 0.25, 8, 0, 8), ((0, 0, 0), 0.0, 8, 8, 8)):
        with pytest.raises(ValueError):
            P.generate_sdf_batch(ok, *bad, backend="cpu")
    with pytest.raises(ValueError):
        P.generate_sdf_batch([(np.zeros((0, 3)), box.tris)], *args,
                             backend="cpu")
    with pytest.raises(ValueError):
        P.generate_sdf_batch([(box.verts, -box.tris.astype(np.int32) - 1)],
                             *args, backend="cpu")
    with pytest.raises(TypeError):
        P.generate_sdf_batch([(box.verts[:, :2], box.tris)], *args,
                             backend="cpu")
    with pytest.raises(TypeError, match="device_mesh"):
        P.generate_sdf_batch(ok, *args, backend="cpu", device_mesh=object())
    with pytest.raises(ValueError):
        P.generate_sdf_batch(ok, *args, backend="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.generate_sdf_batch(ok, *args)


# -- K1's warp tiles and starting bound (csrc/dense.cu), transcribed ---------

CELLS, WARP_J, WARP_K, CENTRE = 4, 8, 16, 18  # dense.cu: kCells, kWarpJ, ...


def _kernel_field(coef, dx, grid_shape, ijk_offset):
    """dense_stream_kernel's walk on the CPU, vectorized over warps: warp
    tile (i, jt, kt) owns columns j = jt*8 + lane // 4 and cells k = kt*16 +
    (lane % 4)*4 + c, clamped copies past the grid's end; each warp finds
    the triangle nearest its centre cell (lane 18's first cell; lowest id
    among ties), starts every cell one ulp above that triangle's distance
    with that triangle as its winner, walks the triangles in ascending
    order, skipping one for the whole warp when no cell's h^2 is within its
    best (degenerate ones never), merges with a strict '<', and keeps the
    start's distance where nothing fell below it. Returns (phi, tid) and
    the share of (warp, triangle) steps evaluated."""
    ni, nj, nk = grid_shape
    oi, oj, ok = ijk_offset
    m = coef.shape[1]
    i, jt, kt = torch.meshgrid(
        torch.arange(ni), torch.arange(-(-nj // WARP_J)),
        torch.arange(-(-nk // WARP_K)), indexing="ij")
    i, jt, kt = (v.reshape(-1, 1) for v in (i, jt, kt))  # (W, 1)
    cell = torch.arange(32 * CELLS)
    lane, c = cell // CELLS, cell % CELLS
    j = jt * WARP_J + lane // (WARP_K // CELLS)            # (W, 128)
    k = kt * WARP_K + (lane % (WARP_K // CELLS)) * CELLS + c
    x = ((i + oi).to(torch.float32) * dx).expand_as(j)
    y = (j.clamp(max=nj - 1) + oj).to(torch.float32) * dx
    z = (k.clamp(max=nk - 1) + ok).to(torch.float32) * dx
    centre = CENTRE * CELLS

    def d2_at(t, x, y, z):
        """din and d2 of the triangles t at the cells, as the twin has them."""
        cf = coef[:, t]
        h = (cf[27] * x + (cf[28] * y + cf[30])) + cf[29] * z
        w23u = cf[31] * x + (cf[32] * y + cf[34])
        w31u = cf[35] * x + (cf[36] * y + cf[38])
        w23v, w31v = cf[33] * z, cf[37] * z
        inside = (torch.minimum(torch.minimum(w23u + w23v, w31u + w31v),
                                (1.0 - w23u - w31u) + -(w23v + w31v)) >= 0.0
                  ) & (cf[39] < 0.5)

        def edge(col, w0, ux, uy, uz):
            s = torch.clamp((cf[col] * x + (cf[col + 1] * y + cf[col + 3]))
                            + cf[col + 2] * z, 0.0, 1.0)
            dd = (ux - s * cf[w0], uy - s * cf[w0 + 1], uz - s * cf[w0 + 2])
            return dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]

        ub = (x - cf[0], y - cf[1], z - cf[2])
        uc = (x - cf[3], y - cf[4], z - cf[5])
        dmin = torch.minimum(edge(15, 6, *ub), torch.minimum(
            edge(19, 9, *uc), edge(23, 12, *uc)))
        return h * h, torch.where(inside, h * h, dmin)

    # the nearest triangle at each warp's centre cell
    tri = torch.arange(m)
    _, dc = d2_at(tri[None, :], x[:, centre:centre + 1],
                  y[:, centre:centre + 1], z[:, centre:centre + 1])
    tmin = torch.argmin(dc, dim=1)  # the first index at the minimum
    assert torch.equal(dc[torch.arange(len(tmin)), tmin], dc.min(dim=1).values)
    _, bound = d2_at(tmin[:, None], x, y, z)
    best = torch.nextafter(bound, torch.tensor(float("inf")))
    best_t = tmin[:, None].expand_as(best).to(torch.int32).clone()
    evaluated = 0
    for t in range(m):
        din, d2 = d2_at(t, x, y, z)
        run = (din <= best).any(dim=1) | bool(coef[39, t] >= 0.5)
        evaluated += int(run.sum())
        better = run[:, None] & (d2 < best)
        best = torch.where(better, d2, best)
        best_t = torch.where(better, t, best_t)
    best = torch.where(best > bound, bound, best)
    phi = torch.full(grid_shape, float("nan"))
    tid = torch.full(grid_shape, -7, dtype=torch.int32)
    store = (j < nj) & (k < nk)
    at = (i.expand_as(j)[store], j[store], k[store])
    phi[at] = sqrt_f32(best[store])
    tid[at] = best_t[store]
    return phi, tid, evaluated / (len(tmin) * m)



@pytest.mark.parametrize("case", ["box36", "ico3_200", "ico3_385", "degen"])
def test_kernel_walk_matches_twin(case):
    """The transcription of dense_stream_kernel's warp tiles, nearest-
    triangle start and culled walk (_kernel_field) writes every cell once
    and equals dense_sep_reference, ids included (ties keep the lowest id
    from a start that is not the lowest): on the 36-triangle box, whose
    coplanar triangles tie exactly on grid planes, on 200 and 385
    triangles (two and four 128-triangle chunks on the card; the
    transcription does not model the staging) on ragged grids with an index
    offset, and on zero-area triangles; its cull skips steps on every real
    mesh."""
    if case == "box36":
        box = P.box_mesh((3, 4, 5), (-1, -1, -1))
        cent = box.verts[box.tris].mean(axis=1).astype(np.float32)
        nv = len(box.verts)
        tris = [(a, b, nv + n) for n, (a0, b0, c0) in enumerate(box.tris)
                for a, b in ((a0, b0), (b0, c0), (c0, a0))]
        tv = np.concatenate([box.verts, cent])[np.asarray(tris)]
        origin, dx, gs, off = (-1.27,) * 3, 0.25, (14, 19, 23), (0, 0, 0)
    elif case == "degen":
        v = np.asarray([[0.5, 0.5, 0.5], [0.2, 0.3, 0.4], [0.9, 0.3, 0.4],
                        [0.1, 0.9, 0.2], [0.8, 0.7, 0.9]], np.float32)
        tv = v[np.asarray([[0, 0, 0], [1, 2, 2], [1, 3, 4]])]
        origin, dx, gs, off = (0, 0, 0), 0.05, (13, 20, 31), (0, 0, 0)
    else:
        mesh = _ico3()
        tv = _tri_verts(mesh, mesh.tris[:int(case[5:])])
        origin, dx, gs, off = (-1.2, -1.15, -1.1), 0.21, (7, 11, 19), (2, 1, 3)
    coef = pdense._sep_coefs(torch.from_numpy(
        np.ascontiguousarray(tv, np.float32) - np.float32(origin)))
    want_phi, want_tid = pdense.dense_sep_reference(coef, dx, grid_shape=gs,
                                                    ijk_offset=off)
    phi, tid, share = _kernel_field(coef, dx, gs, off)
    np.testing.assert_array_equal(phi.numpy().view(np.int32),
                                  want_phi.numpy().view(np.int32))
    np.testing.assert_array_equal(tid.numpy(), want_tid.numpy())
    # two of the three zero-area case's triangles are never skipped
    assert share < (1.0 if case != "degen" else 1.01)
