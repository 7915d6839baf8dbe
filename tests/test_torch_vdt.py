"""K3/K4 plain-torch twins and the pyramid glue against the JAX package on
the CPU.

K3 (``vdt_kernel.round_phase`` on CPU tensors) against ``vdt._jacobi_round``
and ``pallas_round_phase(interpret=True)``: closest-point and id channels
bit-equal, d2 within 2 ulp (interpret mode and XLA:CPU may contract the
three squared differences with FMAs, see tests/test_vdt_pallas.py:6-11).
K4 (``vdt_kernel.chamfer`` on CPU tensors) against ``vdt.chamfer_relax``:
bit-equal; against ``pallas_chamfer(interpret=True)``: rtol 2e-7.
The pyramid cannot be bit-equal to the JAX package's: multi-round near-tie
donor flips cascade (tests/test_vdt_pallas.py:81-83), so it is held to
phi >= 0, >= 99.9% of cells equal to 1e-6*dx and all within 0.05*dx.
The CUDA kernels themselves are held bit-equal to these twins on the card
by chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdfgenfast_tpu.ops import vdt as JV
from sdfgenfast_tpu.ops.vdt_pallas import pallas_chamfer, pallas_round_phase
from sdfgenfast_tpu_torch.ops import vdt as PV
from sdfgenfast_tpu_torch.ops import vdt_kernel

DX = np.float32(0.02)


# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


def _random_state(shape, seed, n_seed=4000):
    """(5, ni, nj, nk) float32 numpy state: FAR except `n_seed` cells with a
    closest point near the cell, a random id (bits) and a consistent d2."""
    rng = np.random.default_rng(seed)
    ni, nj, nk = shape
    state = np.full((5, ni, nj, nk), JV.FAR, np.float32)
    ii, jj, kk = (rng.integers(0, n, n_seed) for n in shape)
    cp = (rng.normal(size=(3, n_seed)).astype(np.float32) * 0.3
          + np.stack([ii, jj, kk]).astype(np.float32) * DX)
    state[0, ii, jj, kk], state[1, ii, jj, kk], state[2, ii, jj, kk] = cp
    state[3, ii, jj, kk] = rng.integers(0, 1 << 24, n_seed).astype(
        np.int32).view(np.float32)
    px, py, pz = (np.arange(n, dtype=np.float32) * DX for n in shape)
    d2 = ((px[:, None, None] - state[0]) ** 2
          + (py[None, :, None] - state[1]) ** 2
          + (pz[None, None, :] - state[2]) ** 2)
    state[4] = d2.astype(np.float32)
    return state


def _assert_round_equal(ours, ref):
    """Channels 0-3 bit-equal, d2 within 2 ulp."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(ours[:4].view(np.int32),
                                  ref[:4].view(np.int32))
    ulp = np.abs(ours[4].view(np.int32).astype(np.int64)
                 - ref[4].view(np.int32).astype(np.int64))
    assert ulp.max() <= 2, f"d2 differs by {ulp.max()} ulp"


def _torch_round(state, stride, scale):
    return vdt_kernel.round_phase(torch.from_numpy(state), float(DX),
                                  (stride,), scale).numpy()


@pytest.mark.parametrize("scale", [1, 4])
@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_round_twin_matches_jnp_round(stride, scale):
    st = _random_state((40, 41, 75), seed=stride + 10 * scale)
    pos = JV._level_pos_axes(st.shape[1:], DX, scale)
    ref = JV._jacobi_round(jnp.asarray(st), *pos, stride,
                           jnp.asarray(JV._OFFSETS26))
    _assert_round_equal(_torch_round(st, stride, scale), ref)


@pytest.mark.parametrize("stride,scale", [(1, 1), (2, 1), (4, 4), (8, 4),
                                          (16, 4)])
def test_round_twin_matches_pallas_round(stride, scale):
    """pallas_round_phase in interpret mode (strides above 8 take its jnp
    branch, which is the same function)."""
    st = _random_state((48, 48, 128), seed=stride)
    ref = pallas_round_phase(jnp.asarray(st), DX, (stride,), scale,
                             interpret=True)
    _assert_round_equal(_torch_round(st, stride, scale), ref)


def test_round_phase_leaves_input_and_chains_rounds():
    st = _random_state((24, 20, 33), seed=3)
    t = torch.from_numpy(st.copy())
    out = vdt_kernel.round_phase(t, float(DX), (4, 2, 1), 2)
    np.testing.assert_array_equal(t.numpy().view(np.int32), st.view(np.int32))
    chained = t
    for s in (4, 2, 1):
        chained = vdt_kernel.round_phase(chained, float(DX), (s,), 2)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  chained.numpy().view(np.int32))


@pytest.mark.parametrize("shape", [(64, 64, 128), (48, 41, 75)])
def test_chamfer_twin_bit_equal_to_jnp(shape):
    rng = np.random.default_rng(1)
    phi = np.abs(rng.normal(size=shape)).astype(np.float32)
    ref = np.asarray(JV.chamfer_relax(jnp.asarray(phi), DX, passes=2))
    ours = vdt_kernel.chamfer(torch.from_numpy(phi), float(DX), 2).numpy()
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_chamfer_twin_matches_pallas_chamfer():
    rng = np.random.default_rng(2)
    phi = np.abs(rng.normal(size=(64, 64, 128))).astype(np.float32)
    ref = np.asarray(pallas_chamfer(jnp.asarray(phi), DX, passes=2,
                                    interpret=True))
    ours = vdt_kernel.chamfer(torch.from_numpy(phi), float(DX), 2).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-7)


def test_pack_state_round_trips_ids():
    tid = torch.tensor([-1, 0, 1, 7, (1 << 24) + 1, 2**31 - 1],
                       dtype=torch.int32)
    z = torch.zeros(6)
    st = PV.pack_state(z, z, z, tid, z)
    np.testing.assert_array_equal(PV.unpack_tid(st[3]).numpy(), tid.numpy())
    ref = JV.pack_state(*(jnp.zeros(6),) * 3, jnp.asarray(tid.numpy()),
                        jnp.zeros(6))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))


@pytest.mark.parametrize("n", [5, 48, 49, 130, 256, 511])
def test_schedules_equal(n):
    assert PV.stride_ladder(n, extra_rounds=1) == JV.stride_ladder(
        n, extra_rounds=1)
    shape = (n, max(n // 2, 1), n + 3)
    assert PV.pyramid_level_shapes(shape) == JV.pyramid_level_shapes(shape)


@pytest.mark.parametrize("shape,scale", [((40, 41, 75), 1), ((21, 20, 19), 2)])
def test_downsample_upsample_bit_equal(shape, scale):
    st = _random_state(shape, seed=5, n_seed=3000)
    ours = PV._downsample2(torch.from_numpy(st), float(DX), scale)
    ref = JV._downsample2(jnp.asarray(st), DX, scale)
    np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))
    pos = PV._level_pos_axes(shape, float(DX), scale, torch.device("cpu"))
    up = PV._upsample_merge(ours, torch.from_numpy(st), *pos)
    jpos = JV._level_pos_axes(shape, DX, scale)
    jup = JV._upsample_merge(ref, jnp.asarray(st), *jpos)
    np.testing.assert_array_equal(up.numpy().view(np.int32),
                                  np.asarray(jup).view(np.int32))


@pytest.mark.parametrize("shape", [(64, 56, 40), (30, 70, 52)])
def test_pyramid_matches_jax(shape):
    """Sparse exact seeds (a frozen 'band') -> the far field everywhere."""
    rng = np.random.default_rng(sum(shape))
    ni, nj, nk = shape
    n_seed = 300
    ii, jj, kk = (rng.integers(0, n, n_seed) for n in shape)
    cp = np.full((3,) + shape, JV.FAR, np.float32)
    foot = (np.stack([ii, jj, kk]).astype(np.float32)
            + rng.normal(size=(3, n_seed)).astype(np.float32)) * DX
    cp[:, ii, jj, kk] = foot
    tid = np.full(shape, -1, np.int32)
    tid[ii, jj, kk] = rng.integers(0, 5000, n_seed)
    upper = np.float32(ni + nj + nk) * DX
    phi0 = np.full(shape, upper, np.float32)
    pos = np.stack([ii, jj, kk]).astype(np.float32) * DX
    phi0[ii, jj, kk] = np.sqrt(((pos - foot) ** 2).sum(0))
    freeze = tid >= 0

    ref_phi, ref_tid = JV.vdt_pyramid_far_field(
        *(jnp.asarray(c) for c in cp), jnp.asarray(tid), jnp.asarray(phi0),
        DX, freeze_mask=jnp.asarray(freeze), extra_polish=2, use_pallas=False)
    phi, out_tid = PV.vdt_pyramid_far_field(
        *(torch.from_numpy(c) for c in cp), torch.from_numpy(tid),
        torch.from_numpy(phi0), float(DX), freeze_mask=torch.from_numpy(freeze),
        extra_polish=2, phase=vdt_kernel.round_phase)
    phi, ref_phi = phi.numpy(), np.asarray(ref_phi)
    assert (phi >= 0).all()
    err = np.abs(phi - ref_phi)
    assert (err <= 1e-6 * DX).mean() >= 0.999, f"{(err > 1e-6 * DX).sum()} cells differ"
    assert err.max() <= 0.05 * DX, f"max err {err.max() / DX:.4f} dx"
    np.testing.assert_array_equal(out_tid.numpy()[freeze], tid[freeze])
    assert out_tid.numpy().min() >= 0  # every cell reached by a seed


def test_round_phase_rejects_bad_state():
    with pytest.raises(ValueError):
        vdt_kernel.round_phase(torch.zeros(4, 3, 3, 3), 0.1, (1,))
    with pytest.raises(ValueError):
        vdt_kernel.round_phase(torch.zeros(5, 3, 3, 3).transpose(1, 3), 0.1,
                               (1,))
    with pytest.raises(ValueError):
        vdt_kernel.chamfer(torch.zeros(3, 3, 3, dtype=torch.float64), 0.1)



# -- K3's plane walk (csrc/vdt_round.cu), transcribed -------------------------

WARPS, TILE_K, AHEAD = 8, 32, 2  # vdt_round.cu: kWarps, kTileK, kAhead
SLOTS = AHEAD + 3  # kSlots


def _ring_walk_round(state, stride, scale, seg):
    """One round as csrc/vdt_round.cu addresses it, for segments of `seg`
    cells along i. Block (bz, by, bx) owns the lattice cells i = ri + (qa0 +
    a) * stride (a < na), j = rj + (qb0 + b) * stride (b < TILE_B: 16 rows
    where a residue class has 16 or more, else 8), k = k0 + kk, and walks
    the planes la = 0 .. na + 1 (lattice row qa0 - 1 + la) through a ring of
    SLOTS plane slots, AHEAD planes staged ahead. A staged position (plane,
    lb, p) holds the state's x, y, z and id at (ri + (qa0 - 1 + plane) *
    stride, rj + (qb0 - 1 + lb) * stride, the k of p: min(stride, TILE_K)
    of halo on each side), or NaN where it is outside the grid (never
    staged, never read). Plane la serves the cells la - 2, la - 1, la, each
    cell's positions in (j offset, k offset) order; donors are excluded by
    index; cell la - 2 retires after plane la, its winner's four words read
    from the slot that must still hold the winner's plane. Vectorized over
    all blocks and threads, planes in order."""
    st = torch.from_numpy(state)
    bits = st.view(torch.int32)
    _, ni, nj, nk = st.shape
    s = stride
    sb = min(s, TILE_K)
    w = TILE_K + 2 * sb
    nan = torch.tensor(float("nan"))

    segs_a = -(-(-(-ni // s)) // seg)
    bz = torch.arange(min(s, ni) * segs_a)
    ri, qa0 = bz // segs_a, (bz % segs_a) * seg
    na = torch.clamp(torch.clamp((ni - ri + s - 1) // s - qa0, max=seg), min=0)
    lat_j = -(-nj // s)
    TILE_B = WARPS * (2 if lat_j >= 2 * WARPS else 1)
    tiles_b = -(-lat_j // TILE_B)
    by = torch.arange(min(s, nj) * tiles_b)
    rj, qb0 = by // tiles_b, (by % tiles_b) * TILE_B
    gj = rj[:, None] + (qb0[:, None] - 1 + torch.arange(TILE_B + 2)) * s
    k0 = torch.arange(-(-nk // TILE_K)) * TILE_K
    p = torch.arange(w)
    gk = (k0[:, None] - s + p if s <= TILE_K
          else k0[:, None] + (p // TILE_K - 1) * s + p % TILE_K)
    # broadcast axes: (nbz, nby, nbx, B, K)
    Z = (slice(None), None, None, None, None)
    gj_b = [gj[:, None, 1 + ob:1 + ob + TILE_B, None] for ob in (-1, 0, 1)]
    gk_b = [gk[None, :, None, (1 + oc) * sb:(1 + oc) * sb + TILE_K]
            for oc in (-1, 0, 1)]

    def plane_row(plane):
        return ri + (qa0 - 1 + plane) * s  # (nbz,)

    slot_plane = [torch.full(bz.shape, -1) for _ in range(SLOTS)]

    def stage(la):
        slot_plane[la % SLOTS] = torch.where((la <= na + 1) & (na > 0), la,
                                             slot_plane[la % SLOTS])

    def read(slot, ob, oc, ids=False):
        """(3, nbz, nby, nbx, B, K): the x, y, z that the cells (b, kk) read
        at (lb = b + 1 + ob, p = kk + (1 + oc) * sb) of a slot; with `ids`,
        also the id bits there (-1 where not staged)."""
        i = plane_row(slot_plane[slot])[Z]
        j, k = gj_b[ob + 1], gk_b[oc + 1]
        ok = ((slot_plane[slot] >= 0)[Z] & (i >= 0) & (i < ni) & (j >= 0)
              & (j < nj) & (k >= 0) & (k < nk))
        at = (i.clamp(0, ni - 1), j.clamp(0, nj - 1), k.clamp(0, nk - 1))
        xyz = torch.where(ok, st[:3, at[0], at[1], at[2]], nan)
        if not ids:
            return xyz
        return xyz, torch.where(ok, bits[3][at], -1)

    def pos(idx):
        return (idx * scale).to(torch.float32) * DX

    j = gj[:, None, 1:-1, None]
    k = gk[None, :, None, sb:sb + TILE_K]
    live = (j < nj) & (k < nk)
    vb = [(j + ob * s >= 0) & (j + ob * s < nj) for ob in (-1, 0, 1)]
    vc = [(k + oc * s >= 0) & (k + oc * s < nk) for oc in (-1, 0, 1)]
    jc, kc = j.clamp(max=nj - 1), k.clamp(max=nk - 1)
    py, pz = pos(j), pos(k)
    shape = torch.broadcast_shapes((len(bz), 1, 1, 1, 1), live.shape)

    # per-element block and thread indices, for the winners' gathers
    ZI, YI, XI, BI, KI = torch.meshgrid(
        *(torch.arange(d) for d in shape), indexing="ij")
    out = torch.full(bits.shape, -1, dtype=torch.int32)
    written = torch.zeros((ni, nj, nk), dtype=torch.int32)
    bd, win = {}, {}
    for la in range(AHEAD):
        stage(la)
    for la in range(int(na.max()) + 2 if len(bz) else 0):
        stage(la + AHEAD)
        slot = la % SLOTS
        runs = (na > 0) & (la < na + 2)  # blocks with no cells return
        assert (slot_plane[slot][runs] == la).all()
        gi = plane_row(la)[Z]
        vrow = (gi >= 0) & (gi < ni)
        has = {0: (la >= 2) & runs, 1: (la >= 1) & (la <= na),
               2: la < na}  # cells la - 2, la - 1, la
        bd[la] = st[4, (gi + s).clamp(0, ni - 1), jc, kc].expand(shape)
        win[la] = torch.full(shape, 13)
        for ob in (-1, 0, 1):
            for oc in (-1, 0, 1):
                donor = vrow & vb[ob + 1] & vc[oc + 1]
                c = read(slot, ob, oc)
                ey = py - c[1]
                ez = pz - c[2]
                ey2, ez2 = ey * ey, ez * ez
                for q, oa in ((0, 1), (1, 0), (2, -1)):
                    a = la - 2 + q
                    if a < 0 or (oa, ob, oc) == (0, 0, 0):
                        continue
                    ex = pos(gi + (1 - q) * -s) - c[0]
                    cd2 = ex * ex + ey2 + ez2
                    use = donor & has[q][Z]
                    # a donor that a stored cell reads is always staged
                    assert not torch.isnan(cd2[use & live]).any()
                    better = use & (cd2 < bd[a])
                    bd[a] = torch.where(better, cd2, bd[a])
                    win[a] = torch.where(
                        better, (oa + 1) * 9 + (ob + 1) * 3 + (oc + 1), win[a])
        if la < 2:
            continue
        a = la - 2  # complete: retire it
        m = win.pop(a)
        oa, ob, oc = m // 9 - 1, (m // 3) % 3 - 1, m % 3 - 1
        store = has[0][Z] & live
        # the winner's plane, still held by its slot, and its four words
        plane = la - 1 + oa
        held = torch.stack(slot_plane)[plane % SLOTS, ZI] == plane
        assert held[store].all()
        at = (ri[ZI] + (qa0[ZI] - 1 + plane) * s, gj[YI, BI + 1 + ob],
              gk[XI, KI + (1 + oc) * sb])
        at = tuple(x.clamp(0, n - 1) for x, n in zip(at, (ni, nj, nk)))
        xyz, tid = st[:3][:, at[0], at[1], at[2]], bits[3][at]
        ci = (gi - s).expand(shape)
        vals = torch.cat([xyz.view(torch.int32), tid[None],
                          bd.pop(a).view(torch.int32)[None]])
        at = (ci[store], jc.expand(shape)[store], kc.expand(shape)[store])
        for ch in range(5):
            out[ch][at] = vals[ch][store]
        written.index_put_(at, torch.ones_like(at[0], dtype=torch.int32),
                           accumulate=True)
    assert (written == 1).all(), "every cell is written by exactly one block"
    return out.numpy()


@pytest.mark.parametrize("stride", [1, 2, 3, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("shape", [(37, 29, 70), (130, 5, 66), (17, 40, 31)])
def test_ring_walk_bit_equal_to_jacobi_round(shape, stride):
    """The kernel's blocks, staging ring and donor addressing, run in torch
    on the CPU, equal vdt._jacobi_round bit for bit on all five channels:
    lattice tiles for every stride (64 takes the three-run halo in k),
    scales 1, 2, 4, segments of 1, 2 and 32 cells (the kernel picks 1 to
    32), tiles of 8 and 16 rows in j, and shapes that end mid-tile on every
    axis."""
    st = _random_state(shape, seed=stride + sum(shape), n_seed=1500)
    for scale, seg in ((1, 1), (2, 32), (4, 2)):
        pos = PV._level_pos_axes(shape, float(DX), scale, torch.device("cpu"))
        want = PV._jacobi_round(torch.from_numpy(st), *pos, stride).numpy()
        got = _ring_walk_round(st, stride, scale, seg)
        np.testing.assert_array_equal(got, want.view(np.int32),
                                      err_msg=f"scale {scale}, seg {seg}")
