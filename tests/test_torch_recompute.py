"""R1b's summation order and R1's per-path evaluation (``csrc/recompute.cu``),
transcribed in torch on the CPU, against the plain twins
``recompute_backward_reference`` and ``recompute_forward_reference``.

R1 (at the end of the file): the per-triangle table as
``recompute_terms_kernel`` builds it, ``cell_d2``'s paths (each cell's
plane weights, then only the projection's distance or the two segments its
case selects) and the kernel's walk of (i, j, k) in chunks of four cells;
bar: bit-equal to the twin, and every cell visited once with the (i, j, k)
of the division.

The per-cell float32 terms are the twin's own (``cell_vjp_reference``, the
autograd terms the kernel reproduces); the transcription sums them as
``recompute_vjp_kernel`` and ``vjp_rows_sum_kernel`` do: the warp ranges of
``vjp_ranges``, 32 cells a step, the carried run's float64 sums per lane,
their sum at a flush, the segmented scan for runs that start and
end in a step, the per-range rows, the sum over 32 row slices and the tree
over them, the float32 cast.

Bars and why: two runs of the transcription are bit-equal (its order is
fixed by n, M and the range split). After the cast it equals the twin's
``index_add_`` sum to within 1 float32 ulp per entry: both sum the same
float32 terms in float64, in another order, whose rounding (~1e-16 of the
terms) shows only where a float64 sum sits on a float32 rounding boundary.
"""

import numpy as np
import pytest
import torch

from sdfgenfast_tpu_torch.ops import dense as pdense
from sdfgenfast_tpu_torch.ops import recompute as prc
from sdfgenfast_tpu_torch.ops import vdt as PV
from sdfgenfast_tpu_torch.testing import box36

torch.set_num_threads(1)

LANE = torch.arange(32)


def _flush_sum(a):
    """flush_carry on the (32, 9) carries: each half of the lanes summed in
    ascending order from 0.0, then lanes 0-15's sum plus lanes 16-31's."""
    half = []
    for lo in (0, 16):
        s = torch.zeros(9, dtype=torch.float64)
        for lane in range(lo, lo + 16):
            s = s + a[lane]
        half.append(s)
    return half[0] + half[1]


def _seg_scan(v, start):
    """The segmented inclusive scan: lane l adds lane l - off's value while
    l - off is in its run (l - off >= start[l]), off = 1 .. 16."""
    for off in (1, 2, 4, 8, 16):
        up = torch.cat([v[:off], v[:-off]])
        v = torch.where((LANE - off >= start)[:, None], v + up, v)
    return v


def _range_sum(keys, vals, begin, end, flush):
    """recompute_vjp_kernel's walk of one warp range; flush(key, sums)."""
    key = -1
    acc = torch.zeros((32, 9), dtype=torch.float64)
    for base in range(begin, end, 32):
        c = base + LANE
        ok = c < end
        t = torch.full((32,), -1, dtype=torch.int64)
        t[ok] = keys[c[ok]]
        g = torch.zeros((32, 9), dtype=torch.float64)
        g[ok] = vals[c[ok]].double()
        same = t == key
        if bool(same.all()):
            acc = acc + g
            continue
        heads = torch.ones(32, dtype=torch.bool)
        heads[1:] = t[1:] != t[:-1]
        hidx = [int(h) for h in torch.nonzero(heads)[:, 0]]
        lead_end = hidx[1] if len(hidx) > 1 else 32
        last = hidx[-1]
        joins = bool(same[0])
        if joins:
            acc[:lead_end] = acc[:lead_end] + g[:lead_end]
        if key >= 0:
            flush(key, _flush_sum(acc))
        mids = [h for h in hidx if h != last and not (joins and h == 0)]
        if mids:
            start = torch.cummax(torch.where(heads, LANE, 0), 0).values
            s = _seg_scan(g, start)
            for h in mids:  # ascending lane order
                tail = hidx[hidx.index(h) + 1] - 1
                if int(t[tail]) >= 0:
                    flush(int(t[tail]), s[tail])
        key = int(t[31])
        acc = torch.where((LANE >= last)[:, None], g, torch.zeros_like(g))
    if key >= 0:
        flush(key, _flush_sum(acc))


def kernel_sum(keys, vals, m, masked=True):
    """The kernel's float32 (M, 9) sum of per-cell terms `vals` ((n, 9)
    float32, 0 where the kernel adds 0) under `keys` ((n,) int64, -1 where
    tid < 0). Up to VJP_ROWS_MAX_TRIS: per-range rows (a key's first flush
    stored, later ones added, a mask of the flushed keys), then the groups
    of slices over the masked entries, each group's tree, the sum over the
    groups; `masked=False` sums zeroed rows in full instead. Above: the atomic variant's flushes in range order (one
    of the orders its atomics may take)."""
    n = len(keys)
    ranges, span = prc.vjp_ranges(n, m)
    if m > prc.VJP_ROWS_MAX_TRIS:
        acc = torch.zeros((m, 9), dtype=torch.float64)

        def add(key, sums):
            acc[key] = acc[key] + sums

        for w in range(ranges):
            _range_sum(keys, vals, w * span, min((w + 1) * span, n), add)
        return acc.float()
    rows = torch.zeros((ranges, m, 9), dtype=torch.float64)
    seen = torch.zeros((ranges, m), dtype=torch.bool)
    for w in range(ranges):
        row = rows[w]

        def add(key, sums, row=row, seen=seen[w]):
            row[key] = row[key] + sums if seen[key] or not masked else sums
            seen[key] = True

        _range_sum(keys, vals, w * span, min((w + 1) * span, n), add)
    rows = rows.reshape(ranges, 9 * m)
    seen = seen.repeat_interleave(9, dim=1) | (not masked)
    groups = prc.vjp_sum_groups(ranges, m)
    total = torch.zeros(9 * m, dtype=torch.float64)
    for g in range(groups):
        part = torch.zeros((32, 9 * m), dtype=torch.float64)
        for y in range(32):
            s = torch.zeros(9 * m, dtype=torch.float64)
            for r in range(g * 32 + y, ranges, 32 * groups):
                s = torch.where(seen[r], s + rows[r], s)
            part[y] = s
        for st in (16, 8, 4, 2, 1):
            part[:st] = part[:st] + part[st:2 * st]
        total = part[0] if groups == 1 else total + part[0]
    return total.float().reshape(m, 9)


def _ordered(x):
    """float32 bits as integers in the order of the values (-0 == +0)."""
    b = x.numpy().view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _runs(rng, n, m, lo, hi):
    out = []
    while len(out) < n:
        out += [int(rng.integers(0, m))] * int(rng.integers(lo, hi + 1))
    return np.asarray(out[:n], np.int32)


def _box36_ids(shape, dx, origin):
    box = box36()
    tv = box.verts[box.tris.astype(np.int64)].astype(np.float32)
    coef = pdense._sep_coefs(torch.from_numpy(tv - np.float32(origin)))
    _, tid = pdense.dense_sep_reference(coef, dx, grid_shape=shape)
    return tv, tid.numpy()


CASES = {
    # name: (M, grid shape, run lengths)
    "m1": (1, (13, 11, 37), None),
    "m36_long_runs": (36, (9, 17, 45), (20, 140)),
    "m36_box36_ids": (36, (22, 29, 37), "box36"),
    "m36_sum_groups": (36, (16, 19, 57), (20, 140)),
    "m1024_short_runs": (1024, (7, 23, 41), (1, 12)),
    "m1025_atomic_side": (1025, (11, 13, 29), (1, 60)),
}


def _case(name):
    m, shape, runs = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n = int(np.prod(shape))
    origin = np.asarray([-1.27, -1.21, -1.33], np.float32)
    dx = np.float32(0.11)
    if runs == "box36":
        dx = np.float32(0.25)
        tv, tid = _box36_ids(shape, float(dx), origin)
    else:
        tv = (rng.normal(size=(m, 3, 3)) * 0.6).astype(np.float32)
        tid = (np.zeros(n, np.int32) if runs is None
               else _runs(rng, n, m, *runs)).reshape(shape)
    tid = tid.copy()
    grad = rng.normal(size=shape).astype(np.float32)
    flat_t, flat_g = tid.reshape(-1), grad.reshape(-1)
    # tid < 0 and grad_phi == 0 cells scattered inside runs, and a stretch
    # of each across a step boundary
    flat_t[rng.random(n) < 0.02] = -1
    flat_t[70:101] = -1
    flat_g[rng.random(n) < 0.05] = 0.0
    flat_g[300:341] = 0.0
    parity = rng.random(shape) < 0.5
    return tv, tid, parity, grad, origin, float(dx), m


def _terms(name):
    """A case's twin arguments, the kernel's keys and per-cell terms, M."""
    tv, tid, parity, grad, origin, dx, m = _case(name)
    n = tid.size
    ranges, span = prc.vjp_ranges(n, m)
    assert ranges > 1 and n % span != 0
    args = (torch.from_numpy(tv), torch.from_numpy(tid),
            torch.from_numpy(parity), torch.from_numpy(grad),
            tuple(float(o) for o in origin), dx,
            float(np.float32(sum(tid.shape)) * np.float32(dx)))
    vals = prc.cell_vjp_reference(*args)
    keys = torch.from_numpy(tid.reshape(-1).astype(np.int64))
    keys = torch.where(keys < 0, -1, keys)
    # the kernel adds exactly 0 for these cells
    zero = (keys < 0) | (torch.from_numpy(grad.reshape(-1)) == 0)
    vals = torch.where(zero[:, None], torch.zeros_like(vals), vals)
    return args, keys, vals, m


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_sum_order_matches_twin(name):
    """The transcription is bit-equal run to run and within 1 float32 ulp
    of the twin: M = 1, 36 (long runs crossing steps and ranges; box36's
    own ids; enough ranges for two groups in the rows' sum), 1024 (short runs: several per step) and 1025 (the atomic
    side); every grid's n is not a multiple of the span; tid = -1 and
    grad_phi = 0 cells sit inside runs."""
    args, keys, vals, m = _terms(name)
    got = kernel_sum(keys, vals, m)
    again = kernel_sum(keys, vals, m)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = prc.recompute_backward_reference(*args).reshape(m, 9)
    ulps = np.abs(_ordered(got) - _ordered(want))
    assert ulps.max() <= 1, f"{int((ulps > 1).sum())} entries beyond 1 ulp"
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("name", sorted(
    k for k, c in CASES.items() if c[0] <= prc.VJP_ROWS_MAX_TRIS))
def test_masked_rows_equal_zeroed_rows(name):
    """The rows are not zeroed: summing only the entries a range flushed,
    from a first store, gives the bits of summing zeroed rows in full (an
    entry left out would add +0.0 to a sum that starts at +0.0)."""
    _, keys, vals, m = _terms(name)
    got = kernel_sum(keys, vals, m)
    want = kernel_sum(keys, vals, m, masked=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_vjp_ranges_split():
    """Ranges cover the cells once, spans are whole warp steps, at least
    VJP_MIN_SPAN cells; the rows of the fixed-order variant stay within
    VJP_ROW_BYTES at M = 1024 and any n, in whole waves where they cap the
    split; the atomic side is not capped by rows."""
    for n, m in [(256 * 341 * 425, 36), (37 * 61 * 45, 1024),
                 (512 ** 3, 1024), (256 ** 3, 81920), (5291, 1), (1, 1),
                 (1 << 31, 36), (33, 1025)]:
        ranges, span = prc.vjp_ranges(n, m)
        assert span % 32 == 0 and (ranges - 1) * span < n <= ranges * span
        assert ranges <= prc.VJP_MAX_RANGES
        assert span >= min(prc.VJP_MIN_SPAN, -(-n // 32) * 32)
        if m <= prc.VJP_ROWS_MAX_TRIS:
            assert ranges * m * 72 <= prc.VJP_ROW_BYTES
    # where the rows cap the split, they take whole waves (less what the
    # span's rounding to 32 cells drops): one at M = 1024
    for m, waves in ((1024, 1), (512, 2), (36, 3)):
        ranges = prc.vjp_ranges(512 ** 3, m)[0]
        assert 0.99 * waves * prc.VJP_WAVE <= ranges <= waves * prc.VJP_WAVE
    # above the cap no row budget applies: the split of a one-triangle mesh
    assert prc.vjp_ranges(256 ** 3, 81920) == prc.vjp_ranges(256 ** 3, 1)
    assert prc.VJP_ROWS_MAX_TRIS == pdense.DENSE_MAX_TRIS
    # the rows' sum: groups of 32 slices fill VJP_SUM_BLOCKS blocks of 32
    # columns where the rows allow, one slice per row at most
    assert prc.vjp_sum_groups(9504, 36) == 24
    assert prc.vjp_sum_groups(68, 36) == 2
    assert prc.vjp_sum_groups(3135, 1024) == prc.vjp_sum_groups(21, 1) == 1


@pytest.mark.parametrize("shape", [(3, 5, 1), (4, 3, 7), (3, 4, 31),
                                   (2, 9, 32), (3, 4, 33), (2, 3, 425)])
def test_walked_cell_index_matches_division(shape):
    """recompute_vjp_kernel divides each lane's first cell into (i, j, k)
    once and then walks it 32 cells a step (k += 32, carried into j and i
    as often as k passes nk, nk < 32 included); every cell of every range
    gets the (i, j, k) of the division."""
    ni, nj, nk = shape
    n = ni * nj * nk
    for m in (1, 2000):
        ranges, span = prc.vjp_ranges(n, m)
        for w in range(ranges):
            begin, end = w * span, min((w + 1) * span, n)
            c0 = begin + np.arange(32)
            ci, cj, ck = c0 // nk // nj, c0 // nk % nj, c0 % nk
            for base in range(begin, end, 32):
                if base > begin:
                    ck = ck + 32
                    while (ck >= nk).any():
                        wrap = ck >= nk
                        ck = np.where(wrap, ck - nk, ck)
                        cj = np.where(wrap, cj + 1, cj)
                        ci = np.where(wrap & (cj == nj), ci + 1, ci)
                        cj = np.where(wrap & (cj == nj), 0, cj)
                c = base + np.arange(32)
                ok = c < end
                want = np.unravel_index(c[ok], shape)
                for got, w_ in zip((ci, cj, ck), want):
                    np.testing.assert_array_equal(got[ok], w_)


def _ijk32(c, nj, nk):
    """cell_world<unsigned>: the flat index and its quotients as uint32."""
    c = np.uint32(c)
    k = c % np.uint32(nk)
    r = c // np.uint32(nk)
    return int(r // np.uint32(nj)), int(r % np.uint32(nj)), int(k)


def _ijk64(c, nj, nk):
    c = np.uint64(c)
    k = c % np.uint64(nk)
    r = c // np.uint64(nk)
    return int(r // np.uint64(nj)), int(r % np.uint64(nj)), int(k)


def test_cell_index_forms_agree_at_2_31():
    """Above 2^31 cells the kernels take the 64-bit form; at the boundary
    the 32-bit form (used below 2^31 cells) gives the same (i, j, k), and
    the positions f32(i) * dx + origin equal the twin's."""
    shape = (1291, 1291, 1291)
    n = int(np.prod(shape))
    assert n > 1 << 31
    start = (1 << 31) - 40
    origin, dx = (-2.5, 0.75, 1e3), 0.013
    pos = prc._cell_positions(start, 40, shape, origin, dx, "cpu")
    for c in range(start, 1 << 31):
        ijk = _ijk32(c, *shape[1:])
        assert ijk == _ijk64(c, *shape[1:])
        assert np.ravel_multi_index(ijk, shape) == c
        for a in range(3):
            want = np.float32(ijk[a]) * np.float32(dx) + np.float32(origin[a])
            assert pos[a][c - start].numpy().view(np.int32) == \
                np.float32(want).view(np.int32)
    # the first cells of the 64-bit range, past every 32-bit signed index
    for c in (1 << 31, (1 << 31) + 1, n - 1):
        assert np.ravel_multi_index(_ijk64(c, *shape[1:]), shape) == c


def test_box36_is_the_benchmark_box():
    """testing.box36: the 3x4x5 box, each of its 12 face triangles split in
    three at its centroid (36 triangles, 8 + 12 vertices), closed."""
    m = box36()
    assert m.tris.shape == (36, 3) and len(m.verts) == 20
    np.testing.assert_allclose(m.bounds()[0], (-1, -1, -1))
    np.testing.assert_allclose(m.bounds()[1], (2, 3, 4))
    edges = {}
    for a, b, c in m.tris.astype(int):
        for e in ((a, b), (b, c), (c, a)):
            edges[e] = edges.get(e, 0) + 1
    assert all(edges.get((b, a)) == 1 for a, b in edges)


# -- R1 (recompute_phi_kernel): the per-triangle table, the per-path
# evaluation and the walk of (i, j, k), transcribed ----------------------


def _d3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def r1_table(tv):
    """recompute_terms_kernel's (M, 32) table, from the wrapper on the CPU
    (its twin): a, b, c, invdet, m13, m23; x13, d; x23, 0; per edge ab,
    ac, bc: dv = x2 - x1 and max(|dv|^2, 1e-30)."""
    launches = prc.recompute_terms.launches
    table = prc.recompute_terms(tv)
    assert prc.recompute_terms.launches == launches
    assert table.shape == (tv.shape[0], prc.R1_TERMS)
    return table


@pytest.mark.parametrize("m", [0, 1, 16])
def test_recompute_terms_columns(m):
    """The table's columns from the vertices, each with triangle_case's and
    seg_closest's operations (x13 = a - c, m13 = |x13|^2, ..., invdet =
    1 / max(m13 m23 - d^2, 1e-30), each edge's dv and max(|dv|^2, 1e-30)),
    on triangles with a zero-area one among them; bad input raises."""
    tv = torch.from_numpy(_r1_mesh()[:m].copy())
    got = r1_table(tv).numpy()
    v = tv.numpy()
    a, b, c = v[:, 0], v[:, 1], v[:, 2]

    def d3(u, w):
        return (u[:, 0] * w[:, 0] + u[:, 1] * w[:, 1]) + u[:, 2] * w[:, 2]

    x13, x23 = a - c, b - c
    m13, m23, d = d3(x13, x13), d3(x23, x23), d3(x13, x23)
    tiny = np.float32(1e-30)
    want = [a, b, c, (np.float32(1) / np.maximum(m13 * m23 - d * d, tiny)
                      )[:, None], m13[:, None], m23[:, None], x13, d[:, None],
            x23, np.zeros((m, 1), np.float32)]
    for x1, x2 in ((a, b), (a, c), (b, c)):
        dv = x2 - x1
        want += [dv, np.maximum(d3(dv, dv), tiny)[:, None]]
    want = np.concatenate(want, 1).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError):
        prc.recompute_terms(tv.double())
    with pytest.raises(ValueError):
        prc.recompute_terms(tv.reshape(-1, 9))


def _seg_d2(p, x1, x2, dv, m2c):
    """seg_d2_terms: seg_closest's distance with dv and m2c from the
    table."""
    t = _d3(tuple(x2[q] - p[q] for q in range(3)), dv) / m2c
    t = torch.minimum(torch.maximum(t, torch.tensor(0.0)), torch.tensor(1.0))
    dd = tuple(p[q] - (t * x1[q] + (1.0 - t) * x2[q]) for q in range(3))
    return _d3(dd, dd)


def r1_transcribed(tv, tid, parity, origin, dx, upper):
    """R1 as cell_d2 evaluates it (the "shared" form: every term from the
    table; the "verts" form computes them per cell with the same
    operations): the plane projection's weights; the projection's distance
    for the inside cells only; for the outside cells, the two segments
    that their case selects, endpoints and edge terms picked per cell.
    Returns (phi, per-path cell counts)."""
    table = r1_table(tv)
    flat = tid.reshape(-1)
    n = flat.numel()
    p_all = prc._cell_positions(0, n, tid.shape, origin, dx, "cpu")
    live = torch.nonzero(flat >= 0)[:, 0]
    T = table[flat[live].long()]
    p = tuple(x[live] for x in p_all)

    def col(i, rows=slice(None)):
        return T[rows, i]

    c = (col(6), col(7), col(8))
    x03 = tuple(p[q] - c[q] for q in range(3))
    pa = _d3((col(12), col(13), col(14)), x03)
    pb = _d3((col(16), col(17), col(18)), x03)
    m13, m23, d, invdet = col(10), col(11), col(15), col(9)
    w23 = invdet * (m23 * pa - d * pb)
    w31 = invdet * (m13 * pb - d * pa)
    w12 = 1.0 - w23 - w31
    inside = (w23 >= 0.0) & (w31 >= 0.0) & (w12 >= 0.0)
    d2 = torch.full((len(live),), float("nan"))
    counts = {}
    rows = torch.nonzero(inside)[:, 0]
    r = rows
    e = tuple(p[q][r] - (w23[r] * col(q, r) + w31[r] * col(3 + q, r)
                         + w12[r] * col(6 + q, r)) for q in range(3))
    d2[r] = _d3(e, e)
    counts["inside"] = len(r)
    # outside: the first segment ab (w23 > 0 or w31 > 0) or ac, the
    # second ac (w23 > 0) or bc, endpoints and edge terms selected
    r = torch.nonzero(~inside)[:, 0]
    pr = tuple(x[r] for x in p)
    ab, ac = (w23[r] > 0.0) | (w31[r] > 0.0), w23[r] > 0.0
    a, b, cr = (tuple(col(o + q, r) for q in range(3)) for o in (0, 3, 6))
    x2f = tuple(torch.where(ab, b[q], cr[q]) for q in range(3))
    x1s = tuple(torch.where(ac, a[q], b[q]) for q in range(3))
    ef = [torch.where(ab, col(20 + q, r), col(24 + q, r)) for q in range(4)]
    es = [torch.where(ac, col(24 + q, r), col(28 + q, r)) for q in range(4)]
    d2[r] = torch.minimum(_seg_d2(pr, a, x2f, tuple(ef[:3]), ef[3]),
                          _seg_d2(pr, x1s, cr, tuple(es[:3]), es[3]))
    counts["w23"], counts["w31"] = int(ac.sum()), int((ab & ~ac).sum())
    counts["rest"] = int((~ab).sum())
    assert not bool(d2.isnan().any())
    dist = torch.full((n,), float(upper))
    dist[live] = PV.sqrt_f32(torch.maximum(d2, torch.tensor(1e-30)))
    flat_par = parity.reshape(-1)
    phi = torch.where(flat_par, -dist, dist).reshape(tid.shape)
    counts["w_zero"] = int(((w23 == 0) | (w31 == 0) | (w12 == 0)).sum())
    counts["w_zero_inside"] = int((inside & ((w23 == 0) | (w31 == 0)
                                             | (w12 == 0))).sum())
    return phi, counts


def _r1_mesh():
    """Triangles in world coordinates: the unit right triangle (weights 1 -
    x - y, x, y at a cell (x, y, z), exact on a grid of quarters), a
    point, a segment (two equal vertices), three collinear vertices, and
    random ones."""
    rng = np.random.default_rng(11)
    special = np.array([
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[0.5, 0.25, 0.5]] * 3,
        [[0, 0, 0.25], [0, 0, 0.25], [1, 0.5, 0.25]],
        [[-0.5, 0, 0], [0, 0.5, 0], [0.5, 1.0, 0]],
    ], np.float32)
    rand = (rng.normal(size=(12, 3, 3)) * 0.7).astype(np.float32)
    return np.concatenate([special, rand])


@pytest.mark.parametrize("shape", [(9, 10, 11), (8, 12, 7), (5, 6, 45)])
def test_r1_per_path_bit_equal_to_twin(shape):
    """The transcription of R1's table and per-path evaluation equals
    recompute_forward_reference bit for bit: cells exactly on w = 0
    boundaries (the right triangle at quarter steps), zero-area triangles
    (a point, a segment, collinear vertices) and tid < 0 cells included;
    every path is taken."""
    rng = np.random.default_rng(sum(shape))
    tv = torch.from_numpy(_r1_mesh())
    m = tv.shape[0]
    n = int(np.prod(shape))
    # the right triangle on half the cells, the degenerate ones often
    tid = np.where(rng.random(n) < 0.5, 0, rng.integers(0, m, n))
    tid = np.where(rng.random(n) < 0.15, rng.integers(1, 4, n), tid)
    tid[rng.random(n) < 0.05] = -1
    tid[:7] = -1
    tid = torch.from_numpy(tid.astype(np.int32).reshape(shape))
    parity = torch.from_numpy(rng.random(shape) < 0.5)
    origin, dx = (-0.5, -0.5, -0.25), 0.25
    upper = float(np.float32(sum(shape)) * np.float32(dx))
    got, counts = r1_transcribed(tv, tid, parity, origin, dx, upper)
    want = prc.recompute_forward_reference(tv, tid, parity, origin, dx, upper)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    assert min(counts["inside"], counts["w23"], counts["w31"],
               counts["rest"], counts["w_zero_inside"]) > 0, counts
    assert counts["w_zero"] > counts["w_zero_inside"], counts


def r1_walk(n, nj, nk, threads, vec):
    """recompute_phi_kernel's cells as its threads visit them, `vec` (4 or
    1) cells a chunk: thread g divides cell vec * g into (i, j, k) once,
    then steps one cell at a time within a chunk (next_cell) and walks vec
    * threads cells between chunks as mixed-radix digits; the n % vec tail
    cells go to threads 0 .. n % vec - 1 (by division). Returns {cell:
    (i, j, k)} and the visit count."""
    plane = nj * nk

    def digits(c):
        return c // plane, c % plane // nk, c % plane % nk

    def walk(ijk, d):
        i, j, k = ijk
        k += d[2]
        if k >= nk:
            k, j = k - nk, j + 1
        j += d[1]
        if j >= nj:
            j, i = j - nj, i + 1
        return i + d[0], j, k

    def next_cell(ijk):
        i, j, k = ijk
        k += 1
        if k == nk:
            k, j = 0, j + 1
            if j == nj:
                j, i = 0, i + 1
        return i, j, k

    seen, visits = {}, 0
    chunks = n // vec
    for g in range(n - vec * chunks):
        c = vec * chunks + g
        seen[c] = digits(c)
        visits += 1
    for g in range(min(threads, chunks)):
        base = digits(vec * g)
        for v in range(g, chunks, threads):
            ijk = base
            for q in range(vec):
                seen[vec * v + q] = ijk
                visits += 1
                ijk = next_cell(ijk)
            base = walk(base, digits(vec * threads))
    return seen, visits


@pytest.mark.parametrize("shape,threads", [((3, 5, 1), 2), ((4, 3, 7), 3),
                                           ((3, 4, 31), 5), ((2, 9, 33), 1),
                                           ((5, 7, 3), 4), ((2, 3, 425), 7),
                                           ((9, 1, 2), 3), ((1, 1, 3), 2)])
def test_r1_walked_cell_index_matches_division(shape, threads):
    """Every cell is visited once, with the (i, j, k) of the division, at
    four cells and one cell a thread: chunks that cross rows and planes,
    nk below 4, a ragged tail, a stride of several planes."""
    n = int(np.prod(shape))
    for vec in prc.R1_CELLS_PER_THREAD:
        seen, visits = r1_walk(n, shape[1], shape[2], threads, vec)
        assert visits == n and sorted(seen) == list(range(n))
        for c, ijk in seen.items():
            assert ijk == np.unravel_index(c, shape)


@pytest.mark.parametrize("m,want", [(1, ("shared", 4)), (36, ("shared", 4)),
                                    (37, ("shared", 1)), (128, ("shared", 1)),
                                    (129, ("verts", 4)), (1024, ("verts", 4)),
                                    (1025, ("verts", 1)),
                                    (81920, ("verts", 1))])
def test_r1_config_by_triangle_count(m, want):
    """r1_config follows R1_CONFIGS' bounds, and every configuration it
    can pick is one that r1_launch takes (the shared table within its
    capacity)."""
    assert prc.r1_config(m) == want
    form, vec = want
    assert form in prc.R1_FORMS and vec in prc.R1_CELLS_PER_THREAD
    assert form != "shared" or m <= prc.R1_SHARED_CAP
