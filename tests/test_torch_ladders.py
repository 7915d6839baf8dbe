"""The flat and capped jump-flood ladders of the PyTorch port
(``sdfgenfast_tpu_torch.ops.vdt``: ``stride_ladder``, ``_gs_round``,
``_gs_axes_round``, ``vdt_far_field``) against the JAX package on the CPU.

Bars and why:

- ``stride_ladder``: equal.
- One Gauss-Seidel round (26 offsets, or the six face offsets in
  sequence): closest-point and id channels bit-equal, d2 within 2 ulp, the
  Jacobi twin's bar (tests/test_torch_vdt.py): the JAX rounds run in a
  ``fori_loop`` whose body XLA compiles, and may contract the three squared
  differences with FMAs.
- ``vdt_far_field``, flat (Gauss-Seidel) and capped (every round Jacobi,
  through ``vdt_kernel.round_phase``, which is K3 on CUDA tensors): the
  pyramid's bar, >= 99.9% of cells within 1e-6*dx and all within 0.05*dx,
  unless the two come out bit-equal, which is then asserted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfgenfast_tpu.ops import vdt as JV
from sdfgenfast_tpu_torch.ops import vdt as PV
from sdfgenfast_tpu_torch.ops import vdt_kernel

DX = np.float32(0.02)
CPU = torch.device("cpu")

# One intra-op thread: the suite runs in several worker processes at
# once, and a PyTorch CPU thread pool per worker oversubscribes the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("max_hop", [None, 1, 4, 8, 16])
@pytest.mark.parametrize("max_dim", [5, 48, 64, 129, 256, 512])
def test_stride_ladder_equal(max_dim, max_hop):
    for extra in (0, 2, 4):
        assert PV.stride_ladder(max_dim, max_hop, extra) == JV.stride_ladder(
            max_dim, max_hop=max_hop, extra_rounds=extra)
    assert PV.stride_ladder(max_dim, max_hop=max_hop) == JV.stride_ladder(
        max_dim, max_hop)


def _seeded_state(shape, seed, n_seed=3000):
    """(5, ni, nj, nk) float32 numpy state: FAR except `n_seed` cells with a
    closest point near the cell, a random id (bits) and a consistent d2."""
    rng = np.random.default_rng(seed)
    state = np.full((5,) + shape, JV.FAR, np.float32)
    ii, jj, kk = (rng.integers(0, n, n_seed) for n in shape)
    cp = (rng.normal(size=(3, n_seed)).astype(np.float32) * 0.3
          + np.stack([ii, jj, kk]).astype(np.float32) * DX)
    state[0, ii, jj, kk], state[1, ii, jj, kk], state[2, ii, jj, kk] = cp
    state[3, ii, jj, kk] = rng.integers(0, 1 << 24, n_seed).astype(
        np.int32).view(np.float32)
    px, py, pz = (np.arange(n, dtype=np.float32) * DX for n in shape)
    state[4] = ((px[:, None, None] - state[0]) ** 2
                + (py[None, :, None] - state[1]) ** 2
                + (pz[None, None, :] - state[2]) ** 2).astype(np.float32)
    return state


def _assert_round_equal(ours, ref):
    """Channels 0-3 bit-equal, d2 within 2 ulp."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_array_equal(ours[:4].view(np.int32),
                                  ref[:4].view(np.int32))
    ulp = np.abs(ours[4].view(np.int32).astype(np.int64)
                 - ref[4].view(np.int32).astype(np.int64))
    assert ulp.max() <= 2, f"d2 differs by {ulp.max()} ulp"


@pytest.mark.parametrize("form", ["gs", "gs_axes"])
@pytest.mark.parametrize("stride", [1, 2, 8, 16])
def test_gs_round_matches_jax(form, stride):
    shape = (36, 29, 44)
    st = _seeded_state(shape, seed=stride + (100 if form == "gs" else 0))
    jpos = JV._pos_axes(shape, DX)
    ppos = PV._level_pos_axes(shape, float(DX), 1, CPU)
    if form == "gs":
        ref = JV._gs_round(jnp.asarray(st), *jpos, stride,
                           jnp.asarray(JV._OFFSETS26))
        ours = PV._gs_round(torch.from_numpy(st), *ppos, stride)
    else:
        ref = JV._gs_axes_round(jnp.asarray(st), *jpos, stride)
        ours = PV._gs_axes_round(torch.from_numpy(st), *ppos, stride)
    _assert_round_equal(ours.numpy(), ref)
    # the round changed the state: candidates were adopted
    assert (ours.numpy()[3].view(np.int32) != st[3].view(np.int32)).any()


def test_gs_round_reads_the_running_state():
    """One seed in a corner, stride 1: a Jacobi round moves it one cell
    (the 2x2x2 corner block); a Gauss-Seidel round, whose offsets read the
    running state, carries it further."""
    shape = (6, 6, 6)
    st = np.full((5,) + shape, JV.FAR, np.float32)
    st[:3, 0, 0, 0] = 0.0
    st[3, 0, 0, 0] = np.int32(7).view(np.float32)
    st[4, 0, 0, 0] = 0.0
    pos = PV._level_pos_axes(shape, float(DX), 1, CPU)
    gs = PV._gs_round(torch.from_numpy(st), *pos, 1)
    jac = vdt_kernel.round_phase_reference(torch.from_numpy(st), float(DX),
                                           (1,), 1)
    reached_gs = (PV.unpack_tid(gs[3]) == 7).sum().item()
    reached_jac = (PV.unpack_tid(jac[3]) == 7).sum().item()
    assert reached_jac == 8  # the 2x2x2 corner block
    assert reached_gs > reached_jac
    ref = JV._gs_round(jnp.asarray(st), *JV._pos_axes(shape, DX), 1,
                       jnp.asarray(JV._OFFSETS26))
    _assert_round_equal(gs.numpy(), ref)


def _far_field_inputs(shape, seed, n_seed=300):
    """Sparse exact seeds (a frozen 'band'): closest points near random
    cells, their ids and distances; upper elsewhere."""
    rng = np.random.default_rng(seed)
    ni, nj, nk = shape
    ii, jj, kk = (rng.integers(0, n, n_seed) for n in shape)
    cp = np.full((3,) + shape, JV.FAR, np.float32)
    foot = (np.stack([ii, jj, kk]).astype(np.float32)
            + rng.normal(size=(3, n_seed)).astype(np.float32)) * DX
    cp[:, ii, jj, kk] = foot
    tid = np.full(shape, -1, np.int32)
    tid[ii, jj, kk] = rng.integers(0, 5000, n_seed)
    phi0 = np.full(shape, np.float32(ni + nj + nk) * DX, np.float32)
    pos = np.stack([ii, jj, kk]).astype(np.float32) * DX
    phi0[ii, jj, kk] = np.sqrt(((pos - foot) ** 2).sum(0))
    return cp, tid, phi0, tid >= 0


@pytest.mark.parametrize("shape", [(40, 36, 44), (30, 52, 23)])
@pytest.mark.parametrize("jacobi", [True, False], ids=["capped", "flat"])
def test_vdt_far_field_matches_jax(shape, jacobi):
    cp, tid, phi0, freeze = _far_field_inputs(shape, sum(shape) + jacobi)
    strides = JV.stride_ladder(max(shape), max_hop=4 if jacobi else None,
                               extra_rounds=2)
    assert PV.stride_ladder(max(shape), 4 if jacobi else None, 2) == strides
    ref_phi, ref_tid = JV.vdt_far_field(
        *(jnp.asarray(c) for c in cp), jnp.asarray(tid), jnp.asarray(phi0),
        DX, strides, freeze_mask=jnp.asarray(freeze), jacobi=jacobi)
    calls = []

    def phase(state, dx, s, scale=1):
        calls.append(tuple(s))
        return vdt_kernel.round_phase(state, dx, s, scale)

    phi, out_tid = PV.vdt_far_field(
        *(torch.from_numpy(c) for c in cp), torch.from_numpy(tid),
        torch.from_numpy(phi0), float(DX), strides,
        freeze_mask=torch.from_numpy(freeze), jacobi=jacobi, phase=phase)
    # every Jacobi round goes through the phase (K3 on CUDA): all of them
    # on the capped ladder, strides 2 and 4 on the flat one
    want = [(s,) for s in strides if jacobi or s in (2, 4)]
    assert calls == want
    phi, ref_phi = phi.numpy(), np.asarray(ref_phi)
    out_tid, ref_tid = out_tid.numpy(), np.asarray(ref_tid)
    assert (phi >= 0).all() and out_tid.min() >= 0
    np.testing.assert_array_equal(out_tid[freeze], tid[freeze])
    np.testing.assert_array_equal(phi[freeze], phi0[freeze])
    if np.array_equal(phi.view(np.int32), ref_phi.view(np.int32)):
        np.testing.assert_array_equal(out_tid, ref_tid)
        return
    err = np.abs(phi - ref_phi)
    assert (err <= 1e-6 * DX).mean() >= 0.999, \
        f"{(err > 1e-6 * DX).sum()} cells differ"
    assert err.max() <= 0.05 * DX, f"max err {err.max() / DX:.4f} dx"


def test_vdt_far_field_default_freeze_is_the_seeds():
    cp, tid, phi0, freeze = _far_field_inputs((20, 18, 22), 4)
    args = ((torch.from_numpy(c) for c in cp), torch.from_numpy(tid),
            torch.from_numpy(phi0), float(DX), PV.stride_ladder(22))
    cp_t, *rest = args
    a = PV.vdt_far_field(*cp_t, *rest, phase=vdt_kernel.round_phase)
    b = PV.vdt_far_field(*(torch.from_numpy(c) for c in cp), *rest,
                         freeze_mask=torch.from_numpy(freeze),
                         phase=vdt_kernel.round_phase)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
