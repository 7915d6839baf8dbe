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

