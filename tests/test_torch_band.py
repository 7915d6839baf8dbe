"""K2's plain-torch twin (``band_kernel.band_rows`` on CPU tensors) against
the JAX package's Pallas band kernel, run in interpret mode on the CPU.

Same setup as tests/test_band_pallas.py (icosphere(4) at 64^3, identical
CSR from the JAX package's bin_mesh). Tolerances: phi and closest points
within rtol 3e-6 (atol 1e-6 for cells on the surface) — the twin and the
Pallas kernel evaluate the same formulas, but the Pallas reduction runs per
16-candidate chunk and XLA may contract differently; ids equal except where
the two distances tie to that tolerance. The CUDA kernel itself is checked
against this twin on the card by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdfgenfast_tpu.grid import sizing_mode2a_proportional
from sdfgenfast_tpu.mesh import icosphere
from sdfgenfast_tpu.ops import band_pallas
from sdfgenfast_tpu.pipeline import SDFConfig, bin_mesh
from sdfgenfast_tpu_torch.ops import band_kernel, tiled
from sdfgenfast_tpu_torch.ops import vdt as pvdt
from sdfgenfast_tpu_torch.ops.vdt import sqrt_f32
from sdfgenfast_tpu_torch.testing import k2_segments


# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def band_setup():
    mesh = icosphere(4, radius=1.0)  # 5120 triangles
    mn, mx = mesh.bounds()
    grid = sizing_mode2a_proportional(mn, mx, 64, 1)
    binned = bin_mesh(mesh, grid, SDFConfig())
    csr = binned.band_csr
    tv = jnp.asarray(mesh.verts)[jnp.asarray(binned.tris)]
    tri_local = tv - jnp.asarray(grid.origin, jnp.float32)
    dx = np.float32(grid.dx)
    jax_rows = band_pallas.band_rows_pallas(
        tri_local, jnp.asarray(csr["pair"]), jnp.asarray(csr["ids"]),
        jnp.asarray(csr["off"]), jnp.asarray(csr["cnt"]), jnp.float32(dx),
        kcap=csr["kcap"], tiles_dim=binned.band.tiles_dim,
        grid_shape=grid.shape, interpret=True)
    args = (torch.from_numpy(np.asarray(tri_local).reshape(-1, 9).copy()),
            *(torch.from_numpy(csr[k]) for k in ("pair", "ids", "off", "cnt")),
            float(dx))
    kw = dict(tiles_dim=binned.band.tiles_dim, grid_shape=grid.shape)
    torch_rows = band_kernel.band_rows(*args, **kw)
    T = int(np.prod(binned.band.tiles_dim))
    rows = csr["ids"][csr["ids"] < T]  # active tiles (pads carry id T)
    _, ntj, ntk = binned.band.tiles_dim
    c = np.arange(512)
    local = np.stack([c // 64, (c // 8) % 8, c % 8], 1)
    base = np.stack([rows // (ntj * ntk), (rows // ntk) % ntj, rows % ntk], 1)
    cell_pos = ((base[:, None, :] * 8 + local[None]).astype(np.float32) * dx)
    return dict(mesh=mesh, grid=grid, binned=binned, rows=rows, args=args,
                kw=kw, cell_pos=cell_pos,
                jax=[np.asarray(r)[rows] for r in jax_rows],
                torch=[r.numpy()[rows] for r in torch_rows],
                torch_full=torch_rows)


def test_band_twin_phi_matches_pallas(band_setup):
    np.testing.assert_allclose(band_setup["torch"][0], band_setup["jax"][0],
                               rtol=3e-6, atol=1e-6)


@pytest.mark.parametrize("channel", ["cpx", "cpy", "cpz"])
def test_band_twin_cp_matches_pallas(band_setup, channel):
    """Closest points agree wherever the winner agrees, to rtol 3e-6 —
    except at a handful of cells (<= 1e-4 of them) whose foot is a triangle
    VERTEX: there the Pallas kernel's feet sit up to ~4e-5 off the vertex,
    along the surface, at the same distance (checked below). Where an
    ulp-level d2 tie picked another triangle (interior cells on a bisector
    of two faces have two feet), the ids differ and so may the feet."""
    i = ("phi", "tid", "cpx", "cpy", "cpz").index(channel)
    t, j = band_setup["torch"], band_setup["jax"]
    same = t[1] == j[1]
    off = same & ~np.isclose(t[i], j[i], rtol=3e-6, atol=1e-6)
    assert off.mean() <= 1e-4, f"{off.sum()} closest points differ"
    if off.any():
        a, c = np.nonzero(off)
        p = band_setup["cell_pos"][a, c]
        dt = np.linalg.norm(p - np.stack([t[k][a, c] for k in (2, 3, 4)], 1), axis=1)
        dj = np.linalg.norm(p - np.stack([j[k][a, c] for k in (2, 3, 4)], 1), axis=1)
        np.testing.assert_allclose(dt, t[0][a, c], rtol=3e-6, atol=1e-6)
        np.testing.assert_allclose(dj, t[0][a, c], rtol=3e-6, atol=1e-6)


def test_band_twin_tids_match_except_ties(band_setup):
    """Same bar as tests/test_band_pallas.py: under 2% of the cells pick
    another triangle, and only where the two distances tie."""
    pt, jt = band_setup["torch"][1], band_setup["jax"][1]
    assert pt.min() >= -1 and pt.max() < band_setup["mesh"].num_tris
    mism = pt != jt
    assert mism.mean() < 0.02, f"{mism.sum()} tid mismatches"
    if mism.any():
        np.testing.assert_allclose(band_setup["torch"][0][mism],
                                   band_setup["jax"][0][mism],
                                   rtol=3e-6, atol=1e-6)


def test_band_closest_points_reproduce_distances(band_setup):
    """|p - cp| == phi wherever a winner was found (cp lies on the winning
    triangle at the evaluated distance)."""
    grid, binned = band_setup["grid"], band_setup["binned"]
    T = int(np.prod(binned.band.tiles_dim))
    phi0, tid0, cpx, cpy, cpz = (
        tiled.untile_rows(r[:T], (8, 8, 8), binned.band.tiles_dim, grid.shape)
        for r in band_setup["torch_full"])
    found = tid0 >= 0
    px, py, pz = pvdt._level_pos_axes(grid.shape, float(np.float32(grid.dx)),
                                      1, torch.device("cpu"))
    d = torch.sqrt(pvdt._dist2(px, py, pz, cpx, cpy, cpz))
    assert found.any()
    np.testing.assert_allclose(d[found].numpy(), phi0[found].numpy(),
                               rtol=3e-5, atol=1e-6)


def test_band_inactive_rows_hold_fill(band_setup):
    """Tiles without an active slot keep (upper, -1, FAR): the pipeline
    untiles the rows without a separate active-row select."""
    grid, binned = band_setup["grid"], band_setup["binned"]
    T = int(np.prod(binned.band.tiles_dim))
    inactive = np.ones(T, bool)
    inactive[band_setup["rows"]] = False
    phi, tid, cpx, _, _ = (r.numpy()[:T][inactive]
                           for r in band_setup["torch_full"])
    upper = np.float32(sum(grid.shape)) * np.float32(grid.dx)
    assert (phi == upper).all() and (tid == -1).all()
    assert (cpx == pvdt.FAR).all()


def test_band_csr_builder_matches_jax():
    rng = np.random.default_rng(0)
    A, K = 37, 21
    counts = rng.integers(1, K + 1, A)
    cand = np.zeros((A, K), np.int32)
    valid = np.zeros((A, K), bool)
    for i, c in enumerate(counts):
        cand[i, :c] = np.sort(rng.integers(0, 999, c))
        valid[i, :c] = True
    got = band_kernel.band_csr_from_binning(cand, valid, 999)
    want = band_pallas.band_csr_from_binning(cand, valid, 999)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_band_rows_rejects_bad_inputs(band_setup):
    tri9, pair, ids, off, cnt, dx = band_setup["args"]
    with pytest.raises(ValueError):
        band_kernel.band_rows(tri9.double(), pair, ids, off, cnt, dx,
                              **band_setup["kw"])
    with pytest.raises(ValueError):
        band_kernel.band_rows(tri9, pair.long(), ids, off, cnt, dx,
                              **band_setup["kw"])
    with pytest.raises(ValueError):
        band_kernel.band_rows(tri9.to("meta"), pair.to("meta"),
                              ids.to("meta"), off.to("meta"), cnt.to("meta"),
                              dx, **band_setup["kw"])


# -- the coefficient table and K2's thread mapping (csrc/band_rows.cu) -------


def _per_candidate_coefs(tri9):
    """The coefficients as the walk built them per candidate before the
    table existed, term by term, keyed by the table's columns."""
    v = tri9.T
    ax, ay, az, bx, by, bz, cx, cy, cz = (v[i] for i in range(9))
    out = {}

    def edge_coef(col, wcol, x1x, x1y, x1z, x2x, x2y, x2z):
        wx, wy, wz = x1x - x2x, x1y - x2y, x1z - x2z
        m2 = wx * wx + wy * wy + wz * wz
        inv = torch.reciprocal(torch.clamp(m2, min=1e-30))
        out.update({wcol: wx, wcol + 1: wy, wcol + 2: wz, col: wx * inv,
                    col + 1: wy * inv, col + 2: wz * inv,
                    col + 3: -(x2x * wx + x2y * wy + x2z * wz) * inv})

    edge_coef(12, 24, ax, ay, az, bx, by, bz)
    edge_coef(16, 27, ax, ay, az, cx, cy, cz)
    edge_coef(20, 30, bx, by, bz, cx, cy, cz)
    x13x, x13y, x13z = ax - cx, ay - cy, az - cz
    x23x, x23y, x23z = bx - cx, by - cy, bz - cz
    m13 = x13x * x13x + x13y * x13y + x13z * x13z
    m23 = x23x * x23x + x23y * x23y + x23z * x23z
    d = x13x * x23x + x13y * x23y + x13z * x23z
    invdet = torch.reciprocal(torch.clamp(m13 * m23 - d * d, min=1e-30))
    g23 = [invdet * (m23 * p - d * q) for p, q in
           ((x13x, x23x), (x13y, x23y), (x13z, x23z))]
    g31 = [invdet * (m13 * q - d * p) for p, q in
           ((x13x, x23x), (x13y, x23y), (x13z, x23z))]
    crx = x13y * x23z - x13z * x23y
    cry = x13z * x23x - x13x * x23z
    crz = x13x * x23y - x13y * x23x
    cr2 = crx * crx + cry * cry + crz * crz
    rn = torch.rsqrt(torch.clamp(cr2, min=1e-37))
    n = [crx * rn, cry * rn, crz * rn]
    for col, f in ((0, n), (4, g23), (8, g31)):
        out.update({col: f[0], col + 1: f[1], col + 2: f[2],
                    col + 3: -(f[0] * cx + f[1] * cy + f[2] * cz)})
    out.update({33: bx, 34: by, 35: bz, 36: cx, 37: cy, 38: cz,
                39: (cr2 <= 1e-30).to(torch.float32)})
    return torch.stack([out[k] for k in range(40)], dim=1)


def _zero_area(tri9):
    """tri9 with a point triangle and a segment triangle appended."""
    a = tri9[:1, :3]
    return torch.cat([tri9, a.repeat(1, 3),
                      torch.cat([a, tri9[:1, 3:6], tri9[:1, 3:6]], 1)])


@pytest.mark.parametrize("source", ["binned", "random", "far"])
def test_band_coefs_match_per_candidate_arithmetic(band_setup, source):
    """The (M, 40) table equals, bit for bit, the coefficients the walk
    built per candidate, for the binned sphere, random triangles and
    triangles 1000 units from the origin, with zero-area ones appended
    (their flag is set)."""
    if source == "binned":
        tri9 = band_setup["args"][0]
    else:
        rng = np.random.default_rng(7)
        tri9 = torch.from_numpy(rng.normal(
            size=(500, 9), scale=0.3).astype(np.float32)
            + np.float32(1000.0 if source == "far" else 0.0))
    tri9 = _zero_area(tri9)
    got = band_kernel.band_coefs(tri9)
    want = _per_candidate_coefs(tri9)
    assert got.shape == (len(tri9), 40) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    assert (got[-2:, 39] == 1).all() and (got[:-2, 39] == 0).all()
    assert band_kernel.band_coefs.launches == 0


CELLS, THREADS, KCHUNK = 8, 64, 64  # band_rows.cu: kCells, kThreads, kChunk


def _retire_cells(cf, x, y, z):
    """The kernel's retirement: the winner's row halves at the thread's
    (x, y), its lane halves at z, the inside test as three compares, and
    p - cp from the plane or the nearest edge."""
    def row(col):  # cx*x + (cy*y + c0), then + cz*z
        return cf[..., col] * x + (cf[..., col + 1] * y + cf[..., col + 3])

    w23u = torch.where(cf[..., 39] != 0, float("-inf"), row(4))
    h = row(0) + cf[..., 2] * z
    w23 = w23u + cf[..., 6] * z
    w31 = row(8) + cf[..., 10] * z
    inside = (w23 >= 0) & (w31 >= 0) & (1.0 - w23 >= w31)

    def edge(col, wcol, ux, uy, uz):
        s = torch.clamp(row(col) + cf[..., col + 2] * z, 0.0, 1.0)
        dd = [u - s * cf[..., wcol + i] for i, u in enumerate((ux, uy, uz))]
        return dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2], dd

    ub = (x - cf[..., 33], y - cf[..., 34], z - cf[..., 35])
    uc = (x - cf[..., 36], y - cf[..., 37], z - cf[..., 38])
    dab, ddab = edge(12, 24, *ub)
    dac, ddac = edge(16, 27, *uc)
    dbc, ddbc = edge(20, 30, *uc)
    d2 = torch.where(inside, h * h, torch.minimum(dab, torch.minimum(dac, dbc)))
    ab = (dab <= dac) & (dab <= dbc)
    ac = ~ab & (dac <= dbc)
    dd = [torch.where(inside, h * cf[..., i], torch.where(
        ab, ddab[i], torch.where(ac, ddac[i], ddbc[i]))) for i in range(3)]
    return d2, dd


def _kernel_rows(tri9, pair, ids, off, cnt, dx, tiles_dim, grid_shape):
    """band_rows_kernel as the CUDA source addresses it, on the CPU: block a
    takes tile ids[a]; thread r owns the cells (r // 8, r % 8, 0..7) of the
    tile, with the row halves at its (x, y) and the lane halves at its 8
    z's; the segment streams through two KCHUNK-candidate buffers (chunk ch
    into buffer ch & 1, real rows only: a sentinel slot keeps whatever the
    buffer held) and the walk skips sentinel ids; the walk keeps the best
    d2 and its id, and retirement evaluates the winner's row from the
    table once more. Vectorized over blocks, threads and cells."""
    coef = band_kernel.band_coefs(tri9)
    M, P = coef.shape[0], pair.shape[0]
    T = int(np.prod(tiles_dim))
    _, ntj, ntk = tiles_dim
    upper = band_kernel._upper(grid_shape, dx)
    rows = band_kernel._filled_rows(T, upper, torch.device("cpu"))
    A = ids.shape[0]
    t = ids.to(torch.int64)
    r = torch.arange(THREADS)
    x = ((t // (ntk * ntj))[:, None] * 8 + r // 8).to(torch.float32) * dx
    y = (((t // ntk) % ntj)[:, None] * 8 + r % 8).to(torch.float32) * dx
    z = ((t % ntk)[:, None] * 8 + torch.arange(CELLS)).to(torch.float32) * dx
    X, Y, Z = x[:, :, None], y[:, :, None], z[:, None, :]  # (A, 64, 8)
    best = torch.full((A, THREADS, CELLS), float("inf"))
    best_id = torch.full((A, THREADS, CELLS), -1, dtype=torch.int32)
    stage = torch.full((A, 2, KCHUNK, 40), float("nan"))
    stage_id = torch.full((A, 2, KCHUNK), -7, dtype=torch.int32)
    n = cnt.to(torch.int64)
    n_chunks = (n + KCHUNK - 1) // KCHUNK
    for ch in range(int(n_chunks.max()) if A else 0):
        b = ch & 1
        slot = ch * KCHUNK + torch.arange(KCHUNK)
        inseg = slot[None, :] < n[:, None]
        pid = pair[(off.to(torch.int64)[:, None] + slot).clamp(max=P - 1)]
        stage_id[:, b] = torch.where(inseg, pid, stage_id[:, b])
        real = inseg & (pid >= 0) & (pid < M)
        stage[:, b] = torch.where(real[..., None],
                                  coef[pid.clamp(0, M - 1).long()], stage[:, b])
        for q in range(KCHUNK):
            idq = stage_id[:, b, q]
            live = inseg[:, q] & (idq >= 0) & (idq < M)
            if not live.any():
                continue
            cf = stage[:, b, q][:, None, None, :]  # (A, 1, 1, 40)
            d2, _ = _retire_cells(cf, X, Y, Z)
            assert not torch.isnan(d2[live]).any()
            better = live[:, None, None] & (d2 < best)
            best = torch.where(better, d2, best)
            best_id = torch.where(better, idq[:, None, None], best_id)
    has = best < float(upper * upper)
    cf = coef[best_id.clamp(min=0).long()]  # the winner's row, from the table
    _, dd = _retire_cells(cf, X, Y, Z)
    out = (torch.where(has, sqrt_f32(best), float(upper)),
           torch.where(has, best_id, -1),
           *(torch.where(has, p - d, float(pvdt.FAR))
             for p, d in zip((X.expand_as(best), Y.expand_as(best),
                              Z.expand_as(best)), dd)))
    for dst, src in zip(rows, out):  # cell r * 8 + c of the tile's row
        dst[t] = src.reshape(A, THREADS * CELLS)
    return rows



@pytest.mark.parametrize("case", ["binned", "hand", "hand_offset_dx"])
def test_kernel_walk_bit_equal_to_reference(band_setup, case):
    """The transcription of band_rows_kernel (_kernel_rows) equals
    band_rows_reference bit for bit on all five row arrays, inactive and
    junk rows included: on the binned CSR of icosphere(4), and on the
    smoke's hand-made segments (testing.k2_segments) of 1, 16, 121 and
    130 real candidates (three chunks; two zero-area candidates) with
    sentinel padding, the far corner tile and a padded slot, at the setup's
    dx and at another one."""
    tri9, pair, ids, off, cnt, dx = band_setup["args"]
    kw = band_setup["kw"]
    if case != "binned":
        tri9, pair, ids, off, cnt = (torch.from_numpy(a) for a in k2_segments(
            tri9.reshape(-1, 3, 3).numpy(), dx, kw["tiles_dim"],
            band_setup["rows"], (1, 16, 121, 128)))
        if case == "hand_offset_dx":
            dx = float(np.float32(dx * 1.37))
    want = band_kernel.band_rows_reference(tri9, pair, ids, off, cnt, dx, **kw)
    got = _kernel_rows(tri9, pair, ids, off, cnt, dx, kw["tiles_dim"],
                       kw["grid_shape"])
    for name, g, w in zip(("phi", "tid", "cpx", "cpy", "cpz"), got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.numpy().view(np.int32), err_msg=name)
    assert (want[1][ids.long()[:-1] if case != "binned" else ids.long()]
            >= 0).any()


def test_retirement_closest_point_equals_tracked(band_setup):
    """Re-evaluating each cell's winner after the walk gives the closest
    point the twin tracks through the walk, bit for bit."""
    tri9, pair, ids, off, cnt, dx = band_setup["args"]
    rows = band_setup["torch_full"]
    coef = band_kernel.band_coefs(tri9)
    active = ids[ids < rows[0].shape[0] - 1].long()
    x, y, z = band_kernel._tile_cells(active, band_setup["kw"]["tiles_dim"],
                                      dx, torch.device("cpu"))
    tid = rows[1][active]
    found = tid >= 0
    _, dd = _retire_cells(coef[tid.clamp(min=0).long()], x, y, z)
    for p, d, tracked in zip((x, y, z), dd, rows[2:]):
        np.testing.assert_array_equal(
            (p - d)[found].numpy().view(np.int32),
            tracked[active][found].numpy().view(np.int32))
    assert found.float().mean() > 0.5
